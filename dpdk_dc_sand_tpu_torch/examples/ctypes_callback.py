"""Teaching example: zero-overhead Python↔native callbacks via ctypes (counterpart of ``examples/ctypes_callback.py``).

The ``cfunc_example`` analog: the reference passes a numba ``cfunc``
through ``scipy.LowLevelCallable`` into a pybind11 consumer
(cfunc_example/example.py:19-40) — the pattern for calling Python-defined
logic from a native hot loop without the interpreter. The same idea is
shown with ``ctypes`` alone: a C-ABI consumer in the port's host library
driven through ``ctypes.CFUNCTYPE``, plus the reverse direction (Python
driving a native hot function), which is how the stream layer uses native
code. Without the host library (no g++) it raises.

Run: ``python -m dpdk_dc_sand_tpu_torch.examples.ctypes_callback``
"""

import ctypes

import numpy as np

from dpdk_dc_sand_tpu_torch.native import load_native


def native_hot_path(n_words: int = 1 << 16) -> int:
    """Python → native: the framework's production direction. Returns the
    pattern check's mismatch count (0 when the library is right)."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("the host library needs g++ on PATH")
    words = np.empty(n_words, np.uint64)
    ptr = words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    lib.sp_fill_pattern(ptr, words.size, 7, 0)
    bad = int(lib.sp_check_pattern(ptr, words.size, 7))
    print(f"native pattern fill+check over {words.size} words: {bad} mismatches")
    return bad


def python_callback_from_native() -> list:
    """Native → Python: a C-ABI callback pointer built with CFUNCTYPE.

    The consumer here is libc's qsort — any native API taking a function
    pointer works identically (scipy.LowLevelCallable's role in the
    reference example). Returns the sorted values.
    """
    libc = ctypes.CDLL("libc.so.6")
    arr = (ctypes.c_int * 8)(5, 3, 8, 1, 9, 2, 7, 4)

    calls = {"n": 0}

    @ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int))
    def compare(a, b):
        calls["n"] += 1
        return a[0] - b[0]

    libc.qsort(arr, len(arr), ctypes.sizeof(ctypes.c_int), compare)
    print(f"qsort via python callback: {list(arr)} ({calls['n']} comparisons)")
    if list(arr) != sorted(arr):
        raise AssertionError(f"qsort through the callback left {list(arr)}")
    return list(arr)


if __name__ == "__main__":
    native_hot_path()
    python_callback_from_native()
