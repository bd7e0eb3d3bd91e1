"""The port's API documentation generator (``python -m dpdk_dc_sand_tpu_torch.docs``):
a page for every module of the package, found by walking it, and an index
that links each, written without importing JAX or the JAX package."""

import pkgutil
import subprocess
import sys

import dpdk_dc_sand_tpu_torch as pkg


def test_docs_document_every_module_without_jax(tmp_path):
    code = (
        "import sys; from dpdk_dc_sand_tpu_torch import docs; "
        f"names = docs.generate(__import__('pathlib').Path({str(tmp_path)!r})); "
        "print('\\n'.join(names)); "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dpdk_dc_sand_tpu')); "
        "assert not bad, bad"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    written = set(proc.stdout.split())
    walked = {m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")}
    assert walked | {pkg.__name__} == written
    assert {"dpdk_dc_sand_tpu_torch.ops.fengine_fused", "dpdk_dc_sand_tpu_torch.docs"} <= written
    index = (tmp_path / "dpdk_dc_sand_tpu_torch.index.html").read_text()
    for name in written:
        assert (tmp_path / f"{name}.html").stat().st_size > 0
        assert f'href="{name}.html"' in index
    page = (tmp_path / "dpdk_dc_sand_tpu_torch.ops.fengine_fused.html").read_text()
    assert "fengine_ablate_reference" in page


def test_docs_module_runs_as_a_script(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "dpdk_dc_sand_tpu_torch.docs", "--out",
                           str(tmp_path)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert "modules documented into" in proc.stdout
    assert (tmp_path / "dpdk_dc_sand_tpu_torch.index.html").exists()
