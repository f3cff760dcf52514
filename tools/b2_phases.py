#!/usr/bin/env python3
"""Where B2 (the two-level forward kernel) spends its time on the GPU.

    python3 tools/b2_phases.py [--tile 64] [--reps 200] [--seed 0]

1. Times the port's B2 kernel (``dwt_fwd2_f32`` of
   ``libdwt_torch/csrc/fused2l.cu``) on a 2144x4096 float32 CDF 9/7
   frame with CUDA events over back-to-back launches made straight
   through ctypes into preallocated bands, so that the wrapper's host
   cost is left out; checks the bands against the plain version (exact).
2. Copies ``fused2l.cu`` into ``build/b2_phases/``, adds a block barrier
   and a ``clock64()`` stamp after each phase of ``fwd2_kernel`` (load,
   level-1 lift, level-1 stores and LL1, level-2 lift, level-2 stores),
   builds it with the port's nvcc flags and runs it once on the same
   frame.  Prints each phase's mean and median cycles per block, a
   block's lifetime, and the most blocks resident on an SM at once.

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

PHASES = (  # a line of fwd2_kernel after which each phase ends, and its name
    ("__pipeline_wait_prior(0);", "load"),
    ("fwd2::lift2d<NST, SYM>(s1", "level-1 lift"),
    ("fwd2::ll1_window(", "level-1 stores, LL1"),
    ("fwd2::lift2d<NST, SYM>(s2", "level-2 lift"),
    ("b2, tile / 4, y0 / 4, x0 / 4, h / 4, w / 4, P);", "level-2 stores"),
)
MAX_BLOCKS = 1 << 14
SLOTS = 9  # per block: stamps 0..5, start and end (globaltimer), SM id


def stamped_source(src: str) -> str:
    """fused2l.cu with a barrier and a clock64 stamp after each phase."""
    k0 = src.index("__global__ void fwd2_kernel")
    k1 = src.index("__global__ void inv2_kernel")
    head, kern, tail = src[:k0], src[k0:k1], src[k1:]
    lines = kern.split("\n")
    for marker, _ in PHASES:
        if not any(marker in ln for ln in lines):
            raise SystemExit(f"fwd2_kernel has no line with {marker!r}; update PHASES")
    out, n = [], 0
    for ln in lines:
        out.append(ln)
        if "extern __shared__" in ln:
            out.append("    const int b2p_id = blockIdx.y * gridDim.x + blockIdx.x;")
            out.append("    B2P_STAMP(0);")
            out.append("    if (threadIdx.x == 0 && b2p_id < B2P_MAX) {"
                       " b2p[b2p_id * B2P_SLOTS + 6] = b2p_now();"
                       " b2p[b2p_id * B2P_SLOTS + 8] = b2p_smid(); }")
        for marker, _ in PHASES:
            if marker in ln:
                n += 1
                out.append(f"    B2P_STAMP({n});")
    out.insert(len(out) - 1 - out[::-1].index("}"),
               "    if (threadIdx.x == 0 && b2p_id < B2P_MAX)"
               " b2p[b2p_id * B2P_SLOTS + 7] = b2p_now();")
    kern = "\n".join(out)
    prelude = f"""
#define B2P_MAX {MAX_BLOCKS}
#define B2P_SLOTS {SLOTS}
__device__ unsigned long long b2p[B2P_MAX * B2P_SLOTS];
__device__ __forceinline__ unsigned long long b2p_now() {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
    return t;
}}
__device__ __forceinline__ unsigned b2p_smid() {{
    unsigned r;
    asm volatile("mov.u32 %0, %smid;" : "=r"(r));
    return r;
}}
#define B2P_STAMP(i)                                                          \\
    do {{                                                                      \\
        __syncthreads();                                                      \\
        if (threadIdx.x == 0 && b2p_id < B2P_MAX)                             \\
            b2p[b2p_id * B2P_SLOTS + (i)] = clock64();                        \\
    }} while (0)
"""
    k = head.rindex("template <typename T, int TILE")
    getter = """
extern "C" int b2p_read(unsigned long long* out, int n) {
    return (int)cudaMemcpyFromSymbol(out, b2p, sizeof(unsigned long long) * n);
}
"""
    return head[:k] + prelude + head[k:] + kern + tail + getter


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tile", type=int, default=64)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("b2_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from libdwt_torch.ops import _cuda
    from libdwt_torch.ops import fused as F

    smi = cs.nvidia_smi()
    h, w, tile = 2144, 4096, args.tile
    rng = np.random.default_rng(args.seed)
    x = torch.from_numpy(rng.random((h, w), dtype=np.float32)).cuda()
    q = [torch.empty((h // 4, w // 4), device="cuda") for _ in range(4)]
    b = [torch.empty((h // 2, w // 2), device="cuda") for _ in range(3)]
    P = F._lift_params(F.get_wavelet("cdf97"), False, False)
    want = cs.leaves(F.fused_dwt2_2level_plain(x, "cdf97"))

    def launch(fn):
        err = fn(*[t.data_ptr() for t in [x] + q + b], h, w, tile, ctypes.byref(P),
                 torch.cuda.current_stream().cuda_stream)
        _cuda.check(err, "dwt_fwd2_f32")

    fn = _cuda.kernel_fn("dwt_fwd2", "f32")
    launch(fn)
    torch.cuda.synchronize()
    err = cs.max_abs([q[0], q[1], q[2], q[3], b[0], b[1], b[2]], want)
    if err != 0:
        raise SystemExit(f"B2 differs from its plain version: max|diff| {err}")
    ms = cs.time_ms(lambda: launch(fn), args.reps, warm=10)
    print(f"B2 {h}x{w} f32 cdf97 tile {tile}: {ms:.4f} ms a launch (CUDA events, "
          f"{args.reps} launches through ctypes), == plain [{smi}]", flush=True)

    out = os.path.join(ROOT, "build", "b2_phases")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "fused2l_phases.cu")
    with open(os.path.join(_cuda.CSRC, "fused2l.cu")) as f:
        text = stamped_source(f.read())
    with open(src, "w") as f:
        f.write(text)
    lib_path = os.path.join(out, "fused2l_phases.so")
    cmd = [_cuda.find_nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o", lib_path, src]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(lib_path)
    pfn = lib.dwt_fwd2_f32
    pfn.argtypes = _cuda._SIGS["dwt_fwd2"]
    pfn.restype = ctypes.c_int
    for _ in range(3):
        launch(pfn)
    torch.cuda.synchronize()
    nblk = -(-w // tile) * -(-h // tile)
    if nblk > MAX_BLOCKS:
        raise SystemExit(f"{nblk} blocks: raise MAX_BLOCKS")
    buf = (ctypes.c_ulonglong * (MAX_BLOCKS * SLOTS))()
    if lib.b2p_read(buf, len(buf)) != 0:
        raise SystemExit("could not read the stamps")
    a = np.frombuffer(buf, dtype=np.uint64).reshape(MAX_BLOCKS, SLOTS)[:nblk]
    a = a.astype(np.int64)
    cyc = np.diff(a[:, : len(PHASES) + 1], axis=1)
    print(f"phases of {nblk} blocks, clock64 cycles a block (a barrier before each "
          f"stamp) [{smi}]:")
    for i, (_, name) in enumerate(PHASES):
        print(f"  {name:22s} mean {cyc[:, i].mean():9.0f}  median "
              f"{np.median(cyc[:, i]):9.0f}")
    total = a[:, len(PHASES)] - a[:, 0]
    start, end, sm = a[:, 6], a[:, 7], a[:, 8]
    print(f"  {'block, stamp 0 to last':22s} mean {total.mean():9.0f}  median "
          f"{np.median(total):9.0f}")
    life = end - start
    print(f"block lifetime {life.mean():.0f} ns mean (globaltimer); kernel span "
          f"{end.max() - start.min()} ns")
    most = []
    for s in np.unique(sm):
        idx = np.where(sm == s)[0]
        events = sorted([(start[i], 1) for i in idx] + [(end[i], -1) for i in idx])
        c = m = 0
        for _, d in events:
            c += d
            m = max(m, c)
        most.append(m)
    print(f"{len(most)} SMs; most blocks resident on an SM at once: {max(most)} "
          f"(mean of the SMs' most {np.mean(most):.2f}); {nblk / len(most):.2f} blocks "
          f"an SM")
    return 0


if __name__ == "__main__":
    sys.exit(main())
