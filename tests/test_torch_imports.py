"""The port stands alone: importing ``libdwt_torch`` and every one of its
modules loads neither JAX nor the JAX package; and the new modules' entry
points put raw input on the card (raising without CUDA), never silently
on the CPU."""
import importlib
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import libdwt_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_the_jax_package():
    names = sorted(m.name for m in pkgutil.walk_packages(libdwt_torch.__path__, "libdwt_torch."))
    for new in ("utils.fix", "ops.interleaved", "ops.conv", "ops.swt", "ops.nsls", "ops.eaw",
                "ops.features", "utils.vecops", "ops.gabor", "utils.io", "utils.nativelib",
                "utils.exr", "utils.cache", "image", "interop", "utils.perf", "selftest",
                "__main__"):
        assert f"libdwt_torch.{new}" in names
    code = (
        "import importlib, sys\n"
        f"for name in ['libdwt_torch'] + {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'libdwt_tpu'))\n"
        "assert not bad, bad\n"
        "import libdwt_torch as t\n"
        "for n in ('eaw_wavedec2', 'eaw_waverec2', 'fdwt2_interleaved', 'idwt2_interleaved',\n"
        "          'nsls_dwt2_level', 'nsls_idwt2_level', 'convolve1', 'find_max_pos',\n"
        "          'analysis_filters', 'iswt1', 'iswt2', 'swt1', 'swt2', 'swt_level'):\n"
        "    assert callable(getattr(t, n)), n\n"
        "import libdwt_torch.image as im\n"
        "assert t.Image is im.Image and t.Volume is im.Volume\n"
        "assert 'libdwt_torch.ops.gabor' in sys.modules and 'libdwt_torch.__main__' in sys.modules\n"
        "print('ok', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


ENTRY_POINTS = [
    ("libdwt_torch.utils.fix", "to_fix", lambda a: (a,)),
    ("libdwt_torch.utils.fix", "dwt2_fix", lambda a: ((a * 512).astype(np.int32),)),
    ("libdwt_torch.ops.interleaved", "fdwt2_interleaved", lambda a: (a,)),
    ("libdwt_torch.ops.conv", "convolve1", lambda a: (a, [0.25, 0.5, 0.25])),
    ("libdwt_torch.ops.swt", "swt2", lambda a: (a,)),
    ("libdwt_torch.ops.nsls", "nsls_dwt2_level", lambda a: (a,)),
    ("libdwt_torch.ops.eaw", "eaw_wavedec2", lambda a: (a,)),
    ("libdwt_torch.ops.features", "denoise2", lambda a: (a,)),
    ("libdwt_torch.utils.vecops", "scale21", lambda a: (a,)),
    ("libdwt_torch.ops.gabor", "gabor_st", lambda a: (a, 4)),
    ("libdwt_torch.ops.gabor", "detect_ridges3", lambda a: (a,)),
    ("libdwt_torch.ops.gabor", "strongest_ridges", lambda a: (a, 2)),
]


@pytest.mark.parametrize("module,name,args", ENTRY_POINTS,
                         ids=[f"{m.rsplit('.', 1)[1]}.{n}" for m, n, _ in ENTRY_POINTS])
def test_raw_input_runs_on_the_card_or_raises(module, name, args):
    """A numpy input goes to the card: without CUDA the entry point raises
    instead of computing on the CPU; ``device='cpu'`` runs it there."""
    fn = getattr(importlib.import_module(module), name)
    a = np.random.default_rng(0).random((16, 16), dtype=np.float32)
    leaves = lambda t: [x for s in t for x in leaves(s)] if isinstance(t, (list, tuple)) else [t]
    if torch.cuda.is_available():
        assert all(t.is_cuda for t in leaves(fn(*args(a))))
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(*args(a))
    assert all(t.device.type == "cpu" for t in leaves(fn(*args(a), device="cpu")))
