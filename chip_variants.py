"""Builds of one CUDA source of the port in variants made by text edits,
shared by the probes (chip_flash_probe.py, chip_int4_probe.py).

``edit`` applies (old, new) replacements and fails when one no longer
applies; ``build_all`` runs one nvcc (``-Xptxas -v``) per variant, all
started together, and logs ptxas's resource lines and performance-loss
notes (serialised wgmma) for the kernels named;
``use`` points a wrapper module at a variant's source and loads its
library.
"""

import subprocess
from concurrent.futures import ThreadPoolExecutor

from chip_smoke import log
from sea_tpu_torch.ops import _build


def edit(text, edits):
    """text with each (old, new) of edits replaced; AssertionError when an
    old string is not in the text (the source moved on: update the
    variant)."""
    for old, new in edits:
        if old not in text:
            raise AssertionError(f"edit no longer applies: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_all(out, source, texts, kernel, label):
    """Each texts[name] written to out/<name>/<source> and built there into
    lib.so, one nvcc each, started together. Logs, per variant, ptxas's
    stack, spill, register and shared-memory lines for every kernel whose
    mangled name holds `kernel` (a string, or a tuple of which any one
    will do; in label's order)."""
    nvcc = _build._nvcc()
    names = (kernel,) if isinstance(kernel, str) else kernel

    def one(name):
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        (d / source).write_text(texts[name])
        proc = subprocess.run(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(d / "lib.so"), str(d / source)],
            capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
        lines = proc.stderr.splitlines()
        usage = [" ".join(x.split(":", 1)[-1].strip() for x in
                          lines[i + 1:i + 4])
                 for i, line in enumerate(lines)
                 if "Compiling entry" in line
                 and any(k in line for k in names)]
        # ptxas's notes that it serialised a kernel's wgmma (C7520 and
        # the like), which cost it the tensor cores' overlap
        losses = [line.split("ptxas info    :", 1)[-1].strip()
                  for line in lines
                  if "Performance Loss" in line
                  and any(k in line for k in names)]
        return name, usage, losses

    with ThreadPoolExecutor(len(texts)) as pool:
        for name, usage, losses in pool.map(one, texts):
            log(f"[probe-build] {name}: {label}: {usage}")
            for loss in losses:
                log(f"[probe-build] {name}: ptxas: {loss}")


def use(out, name, source, module):
    """Point `module` (a kernel wrapper of sea_tpu_torch.ops with a cached
    ``_library``) at out/<name>/<source>, and return the loaded library."""
    _build.CSRC = out / name
    _build._LIBS.clear()
    module._library.cache_clear()
    return _build.load_library(source.removesuffix(".cu"))
