"""HTML API documentation of the port from its docstrings.

The port's counterpart of ``docs/generate.py`` (which documents the JAX
package): the standard library's ``pydoc`` HTML writer documents every
module of ``dpdk_dc_sand_tpu_torch``, found by walking the package, into
``docs/api/`` (ignored by git) beside an index,
``dpdk_dc_sand_tpu_torch.index.html``. It imports each module, so it needs
no card and imports no JAX. Run from the repo root::

    python -m dpdk_dc_sand_tpu_torch.docs [--out DIR]
"""

from __future__ import annotations

import argparse
import html
import importlib
import pkgutil
import pydoc
import sys
from pathlib import Path

PACKAGE = "dpdk_dc_sand_tpu_torch"
#: Where the pages go by default: ``docs/api/`` of the checkout.
OUT = Path(__file__).resolve().parent.parent / "docs" / "api"


def module_names() -> list[str]:
    """Every module of the package, the package first."""
    pkg = importlib.import_module(PACKAGE)
    return [PACKAGE] + [m.name for m in pkgutil.walk_packages(pkg.__path__, PACKAGE + ".")]


def _summary(mod) -> str:
    doc = (mod.__doc__ or "").strip()
    return doc.splitlines()[0] if doc else ""


def generate(out: Path = OUT) -> list[str]:
    """Write a page a module and the index into ``out``; returns the modules
    written. A module that fails to import raises."""
    out.mkdir(parents=True, exist_ok=True)
    names = module_names()
    rows = []
    for name in names:
        mod = importlib.import_module(name)
        page = pydoc.html.page(pydoc.describe(mod), pydoc.html.document(mod, name))
        (out / f"{name}.html").write_text(page, errors="replace")
        rows.append(f'<li><a href="{name}.html"><code>{name}</code></a> — '
                    f"{html.escape(_summary(mod))}</li>")
    index = (f"<html><head><title>{PACKAGE} API</title></head><body><h1>{PACKAGE}</h1>"
             f"<ul>\n" + "\n".join(rows) + "\n</ul></body></html>\n")
    (out / f"{PACKAGE}.index.html").write_text(index)
    return names


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=OUT, help="directory for the pages")
    args = ap.parse_args(argv)
    names = generate(args.out)
    print(f"{len(names)} modules documented into {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
