#!/usr/bin/env python3
"""Where B5 (the two-level inverse kernel) spends its time on the GPU.

    python3 tools/b5_phases.py [--tile 64] [--reps 200] [--seed 0]

1. Times the port's B5 kernel (``dwt_inv2_f32`` of
   ``libdwt_torch/csrc/fused2l.cu``) on the bands of a 2144x4096 float32
   CDF 9/7 frame with CUDA events over back-to-back launches made straight
   through ctypes into a preallocated output, so that the wrapper's host
   cost is left out; checks the output against the plain version (exact).
2. Copies ``fused2l.cu`` into ``build/b5_phases/``, adds a block barrier
   and a ``clock64()`` stamp after each phase of ``inv2_kernel`` (level-2
   load, level-2 lift, LL1 copy, the wait for the level-1 load, level-1
   lift, stores), builds it with the port's nvcc flags, runs it on the
   same bands and checks it again.  Prints each phase's mean and median
   cycles per block, a block's lifetime, and the most blocks resident on
   an SM at once.

Needs one CUDA card and nvcc; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASES = (  # a line of inv2_kernel after which each phase ends, and its name
    ("__pipeline_wait_prior(1);", "level-2 load"),
    ("inv2::lift2d<NST, SYM>(s2", "level-2 lift"),
    ("inv2::ll1_window(", "LL1 copy"),
    ("__pipeline_wait_prior(0);", "level-1 load wait"),
    ("inv2::lift2d<NST, SYM>(s1", "level-1 lift"),
    ("inv2::store(", "stores"),
)
MAX_BLOCKS = 1 << 14
NP = len(PHASES)
SLOTS = NP + 4  # per block: stamps 0..NP, start and end (globaltimer), SM id


def stamped_source(src: str) -> str:
    """fused2l.cu with a barrier and a clock64 stamp after each phase of
    inv2_kernel."""
    k0 = src.index("__global__ void inv2_kernel")
    k1 = src.index("\n}\n", k0) + 2
    head, kern, tail = src[:k0], src[k0:k1], src[k1:]
    lines = kern.split("\n")
    for marker, _ in PHASES:
        if sum(marker in ln for ln in lines) != 1:
            raise SystemExit(f"inv2_kernel has no single line with {marker!r}; update PHASES")
    out, n = [], 0
    for ln in lines:
        out.append(ln)
        if "extern __shared__" in ln:
            out.append("    const int b5p_id = blockIdx.y * gridDim.x + blockIdx.x;")
            out.append("    B5P_STAMP(0);")
            out.append(f"    if (threadIdx.x == 0 && b5p_id < B5P_MAX) {{"
                       f" b5p[b5p_id * B5P_SLOTS + {NP + 1}] = b5p_now();"
                       f" b5p[b5p_id * B5P_SLOTS + {NP + 3}] = b5p_smid(); }}")
        for marker, _ in PHASES:
            if marker in ln:
                n += 1
                out.append(f"    B5P_STAMP({n});")
    out.insert(len(out) - 1 - out[::-1].index("}"),
               f"    if (threadIdx.x == 0 && b5p_id < B5P_MAX)"
               f" b5p[b5p_id * B5P_SLOTS + {NP + 2}] = b5p_now();")
    prelude = f"""
#define B5P_MAX {MAX_BLOCKS}
#define B5P_SLOTS {SLOTS}
__device__ unsigned long long b5p[B5P_MAX * B5P_SLOTS];
__device__ __forceinline__ unsigned long long b5p_now() {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
    return t;
}}
__device__ __forceinline__ unsigned b5p_smid() {{
    unsigned r;
    asm volatile("mov.u32 %0, %smid;" : "=r"(r));
    return r;
}}
#define B5P_STAMP(i)                                                          \\
    do {{                                                                      \\
        __syncthreads();                                                      \\
        if (threadIdx.x == 0 && b5p_id < B5P_MAX)                             \\
            b5p[b5p_id * B5P_SLOTS + (i)] = clock64();                        \\
    }} while (0)
"""
    k = head.rindex("template <typename T, int TILE")
    getter = """
extern "C" int b5p_read(unsigned long long* out, int n) {
    return (int)cudaMemcpyFromSymbol(out, b5p, sizeof(unsigned long long) * n);
}
"""
    return head[:k] + prelude + head[k:] + "\n".join(out) + tail + getter


def most_resident(start, end, sm):
    """The most blocks resident on each SM at once, from their lifetimes."""
    import numpy as np

    most = []
    for s in np.unique(sm):
        idx = np.where(sm == s)[0]
        events = sorted([(start[i], 1) for i in idx] + [(end[i], -1) for i in idx])
        c = m = 0
        for _, d in events:
            c += d
            m = max(m, c)
        most.append(m)
    return most


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tile", type=int, default=64)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("b5_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from libdwt_torch.ops import _cuda
    from libdwt_torch.ops import fused as F

    smi = cs.nvidia_smi()
    h, w, tile = 2144, 4096, args.tile
    rng = np.random.default_rng(args.seed)
    x = torch.from_numpy(rng.random((h, w), dtype=np.float32)).cuda()
    ll2, b2, b1 = F.fused_dwt2_2level_plain(x, "cdf97")
    ins = [a.contiguous() for a in (ll2, *b2, *b1)]
    out = torch.empty((h, w), device="cuda")
    P = F._lift_params(F.get_wavelet("cdf97"), False, True)
    want = F.fused_idwt2_2level_plain(ins[0], tuple(ins[1:4]), tuple(ins[4:]), "cdf97")

    def launch(fn):
        err = fn(*[t.data_ptr() for t in ins + [out]], h, w, tile, ctypes.byref(P),
                 torch.cuda.current_stream().cuda_stream)
        _cuda.check(err, "dwt_inv2_f32")

    fn = _cuda.kernel_fn("dwt_inv2", "f32")
    launch(fn)
    torch.cuda.synchronize()
    err = cs.max_abs(out, want)
    if err != 0:
        raise SystemExit(f"B5 differs from its plain version: max|diff| {err}")
    ms = cs.time_ms(lambda: launch(fn), args.reps, warm=10)
    print(f"B5 {h}x{w} f32 cdf97 tile {tile}: {ms:.4f} ms a launch (CUDA events, "
          f"{args.reps} launches through ctypes), == plain [{smi}]", flush=True)

    bdir = os.path.join(ROOT, "build", "b5_phases")
    os.makedirs(bdir, exist_ok=True)
    src = os.path.join(bdir, "fused2l_phases.cu")
    with open(os.path.join(_cuda.CSRC, "fused2l.cu")) as f:
        text = stamped_source(f.read())
    with open(src, "w") as f:
        f.write(text)
    lib_path = os.path.join(bdir, "fused2l_phases.so")
    cmd = [_cuda.find_nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o", lib_path, src]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(lib_path)
    pfn = lib.dwt_inv2_f32
    pfn.argtypes = _cuda._SIGS["dwt_inv2"]
    pfn.restype = ctypes.c_int
    out.zero_()
    for _ in range(3):
        launch(pfn)
    torch.cuda.synchronize()
    if cs.max_abs(out, want) != 0:
        raise SystemExit("the stamped B5 differs from its plain version")
    nblk = -(-w // tile) * -(-h // tile)
    if nblk > MAX_BLOCKS:
        raise SystemExit(f"{nblk} blocks: raise MAX_BLOCKS")
    buf = (ctypes.c_ulonglong * (MAX_BLOCKS * SLOTS))()
    if lib.b5p_read(buf, len(buf)) != 0:
        raise SystemExit("could not read the stamps")
    a = np.frombuffer(buf, dtype=np.uint64).reshape(MAX_BLOCKS, SLOTS)[:nblk]
    a = a.astype(np.int64)
    cyc = np.diff(a[:, : NP + 1], axis=1)
    print(f"phases of {nblk} blocks, clock64 cycles a block (a barrier before each "
          f"stamp) [{smi}]:")
    for i, (_, name) in enumerate(PHASES):
        print(f"  {name:22s} mean {cyc[:, i].mean():9.0f}  median "
              f"{np.median(cyc[:, i]):9.0f}")
    total = a[:, NP] - a[:, 0]
    start, end, sm = a[:, NP + 1], a[:, NP + 2], a[:, NP + 3]
    print(f"  {'block, stamp 0 to last':22s} mean {total.mean():9.0f}  median "
          f"{np.median(total):9.0f}")
    life = end - start
    print(f"block lifetime {life.mean():.0f} ns mean (globaltimer); kernel span "
          f"{end.max() - start.min()} ns")
    most = most_resident(start, end, sm)
    print(f"{len(most)} SMs; most blocks resident on an SM at once: {max(most)} "
          f"(mean of the SMs' most {np.mean(most):.2f}); {nblk / len(most):.2f} blocks "
          f"an SM")
    return 0


if __name__ == "__main__":
    sys.exit(main())
