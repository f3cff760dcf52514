#!/usr/bin/env python3
"""Where a hand-written 2-D kernel spends its time on the GPU: B1, B4 (the
one-level kernels of csrc/level.cu), B2, B5 (the two-level kernels of
csrc/fused2l.cu), B3, B6 (the deep tails of csrc/deep.cu).

    python3 tools/kernel_phases.py B3 [B6 B1 B4 B2 B5] [--tile N] [--reps 200] [--seed 0]

For each kernel named, on the main path's shapes (2144x4096 float32 CDF
9/7: B1 and B2 on the frame, B4 on its one-level bands, B5 on its
two-level bands, B3 on its 536x1024 LL2 for three levels, B6 on those
three levels' bands):

1. Times the kernel with CUDA events over back-to-back launches made
   straight through ctypes into preallocated outputs, so that the
   wrapper's host cost is left out; checks the outputs against the plain
   version (exact).
2. Copies the kernel's source into ``build/kernel_phases/<kernel>/``,
   adds a block barrier and a ``clock64()`` stamp after each phase of the
   kernel function (the phases are KERNELS[...]["phases"]: a line of the
   kernel after which each ends), builds it with the port's nvcc flags,
   runs it on the same inputs and checks it again.  Prints each phase's
   mean and median cycles per block (per level for B3/B6, whose phases
   repeat once a level: load, lift, stores, grid sync), a block's
   lifetime, the most blocks resident on an SM at once, and (B1, B3, B4,
   B6) the blocks an SM that the occupancy query allows the stamped
   kernel at its tile's shared memory.

A kernel is data here: its source, kernel function, entry point, phase
markers, the variable that counts its rounds, and a function that makes
its inputs, outputs, plain results and launch.  Needs one CUDA card and
nvcc; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

H, W, WV, DEEP_LEVELS = 2144, 4096, "cdf97", 3
MAX_BLOCKS = 1 << 14
#: threads a block of every kernel here (THREADS in their sources)
THREADS = 256

KERNELS = {
    "B1": {"source": "level.cu", "kernel": "fwd1_kernel", "entry": "dwt_fwd1",
           "tile": 32, "round": None, "instance": "fwd1_kernel<float, 4, true, 0>",
           "phases": (("__pipeline_wait_prior(0);", "load"),
                      ("lines::lift_fwd<NST, SYM>(", "lift"),
                      ("onelevel::fwd_store(", "stores"))},
    "B4": {"source": "level.cu", "kernel": "inv1_kernel", "entry": "dwt_inv1",
           "tile": 32, "round": None, "instance": "inv1_kernel<float, 4, true, 0>",
           "phases": (("__pipeline_wait_prior(0);", "load"),
                      ("lines::lift_inv<NST, SYM>(", "lift"),
                      ("onelevel::inv_store(", "stores"))},
    "B2": {"source": "fused2l.cu", "kernel": "fwd2_kernel", "entry": "dwt_fwd2",
           "tile": 64, "round": None,
           "phases": (("__pipeline_wait_prior(0);", "load"),
                      ("lines::lift_fwd<NST, SYM>(s1", "level-1 lift"),
                      ("fwd2::ll1_window(", "level-1 stores, LL1"),
                      ("lines::lift_fwd<NST, SYM>(s2", "level-2 lift"),
                      ("b2, tile / 4, tile / 4, y0 / 4, x0 / 4, h / 4, w / 4, P);",
                       "level-2 stores"))},
    "B5": {"source": "fused2l.cu", "kernel": "inv2_kernel", "entry": "dwt_inv2",
           "tile": 64, "round": None,
           "phases": (("__pipeline_wait_prior(1);", "level-2 load"),
                      ("lines::lift_inv<NST, SYM>(s2", "level-2 lift"),
                      ("inv2::ll1_window(", "LL1 copy"),
                      ("__pipeline_wait_prior(0);", "level-1 load wait"),
                      ("lines::lift_inv<NST, SYM>(s1", "level-1 lift"),
                      ("inv2::store(", "stores"))},
    "B3": {"source": "deep.cu", "kernel": "deep_fwd_kernel", "entry": "dwt_deep_fwd",
           "body": ("deep.cuh", "fwd_levels"),
           "tile": 32, "round": "k", "instance": "deep_fwd_kernel<float, 4, true>",
           "phases": (("__pipeline_wait_prior(0);", "load"),
                      ("lines::lift_fwd<NST, SYM>(", "lift"),
                      ("fwd_store(s, RS, L, y0, x0, P);", "stores"),
                      ("if (k + 1 < d.n) grid.sync();", "grid sync"))},
    "B6": {"source": "deep.cu", "kernel": "deep_inv_kernel", "entry": "dwt_deep_inv",
           "body": ("deep.cuh", "inv_levels"),
           "tile": 32, "round": "k", "instance": "deep_inv_kernel<float, 4, true>",
           "phases": (("__pipeline_wait_prior(0);", "load"),
                      ("lines::lift_inv<NST, SYM>(", "lift"),
                      ("inv_store(s, RS, L, y0, x0);", "stores"),
                      ("if (k + 1 < d.n) grid.sync();", "grid sync"))},
}


def window_smem(tile: int) -> int:
    """Shared memory (bytes, float32) of the one-level window of B1, B3,
    B4 and B6 at ``tile``: (2 tile + 8) rows of lines::stride columns."""
    e = 2 * tile + 8
    return 4 * e * (e if e % 4 else e + 2)


def _function(text: str, name: str, kind: str):
    """(start, end) of the function ``name`` in ``text``: from the line of
    its ``kind`` (``__global__`` or ``template <``) to its closing brace at
    the start of a line."""
    k0 = text.rindex(kind, 0, text.index(name + "("))
    k0 = text.rindex("\n", 0, k0) + 1
    return k0, text.index("\n}\n", k0) + 2


def _stamp_phases(lines, spec):
    """``lines`` with a barrier and a stamp after the one line of each phase
    marker: slot 1 + round * NP + i after phase i of a round."""
    phases, np_, rnd = spec["phases"], len(spec["phases"]), spec["round"] or "0"
    for marker, _ in phases:
        if sum(marker in ln for ln in lines) != 1:
            raise SystemExit(f"{spec['kernel']} has no single line with {marker!r}; "
                             "update its phases")
    out = []
    for ln in lines:
        out.append(ln)
        for i, (marker, _) in enumerate(phases):
            if marker in ln:
                out.append(f"    KP_STAMP(1 + ({rnd}) * {np_} + {i});")
    return out


def stamped_source(src: str, spec: dict, rounds: int, body: str = ""):
    """``src`` with a barrier and a clock64 stamp after each phase of the
    spec's kernel function, or, where the spec names a ``body`` (a header
    and a device function the kernel calls), of that function in ``body``
    (the header's text): per block, slot 0 at its start and slot 1 + round
    * NP + i after phase i of a round; then the globaltimer at the block's
    start and end, and its SM.  Where the spec names an ``instance`` of the
    kernel, ``kp_occupancy`` gives the blocks an SM that
    cudaOccupancyMaxActiveBlocksPerMultiprocessor allows it.  Returns the
    stamped source and the stamped header ("" without a body)."""
    nstamp = 1 + rounds * len(spec["phases"])
    k0, k1 = _function(src, spec["kernel"], "__global__")
    head, kern, tail = src[:k0], src[k0:k1], src[k1:]
    lines = kern.split("\n")
    if not body:
        lines = _stamp_phases(lines, spec)
    out = []
    for ln in lines:
        out.append(ln)
        if "extern __shared__" in ln:
            out.append("    KP_STAMP(0);")
            out.append(f"    if (threadIdx.x == 0 && KP_ID < KP_MAX) {{"
                       f" kp[KP_ID * KP_SLOTS + {nstamp}] = kp_now();"
                       f" kp[KP_ID * KP_SLOTS + {nstamp + 2}] = kp_smid(); }}")
    out.insert(len(out) - 1 - out[::-1].index("}"),
               f"    if (threadIdx.x == 0 && KP_ID < KP_MAX)"
               f" kp[KP_ID * KP_SLOTS + {nstamp + 1}] = kp_now();")
    stamped_body = ""
    if body:
        b0, b1 = _function(body, spec["body"][1], "template <")
        stamped_body = (body[:b0] + "\n".join(_stamp_phases(body[b0:b1].split("\n"), spec))
                        + body[b1:])
    prelude = f"""
#define KP_MAX {MAX_BLOCKS}
#define KP_SLOTS {nstamp + 3}
#define KP_ID ((int)(blockIdx.y * gridDim.x + blockIdx.x))
__device__ unsigned long long kp[KP_MAX * KP_SLOTS];
__device__ __forceinline__ unsigned long long kp_now() {{
    unsigned long long t;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
    return t;
}}
__device__ __forceinline__ unsigned kp_smid() {{
    unsigned r;
    asm volatile("mov.u32 %0, %smid;" : "=r"(r));
    return r;
}}
#define KP_STAMP(i)                                                          \\
    do {{                                                                     \\
        __syncthreads();                                                     \\
        if (threadIdx.x == 0 && KP_ID < KP_MAX)                              \\
            kp[KP_ID * KP_SLOTS + (i)] = clock64();                          \\
    }} while (0)
"""
    getter = """
extern "C" int kp_read(unsigned long long* out, int n) {
    return (int)cudaMemcpyFromSymbol(out, kp, sizeof(unsigned long long) * n);
}
extern "C" int kp_clear(int n) {
    void* p = nullptr;
    int err = (int)cudaGetSymbolAddress(&p, kp);
    return err ? err : (int)cudaMemset(p, 0, sizeof(unsigned long long) * n);
}
"""
    if "instance" in spec:
        getter += f"""
extern "C" int kp_occupancy(int* blocks, int threads, int smem) {{
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, {spec["instance"]},
                                                              threads, (size_t)smem);
}}
"""
    # the prelude comes first: a stamped header uses its macros
    return prelude + head + "\n".join(out) + tail + getter, stamped_body


def make_case(kid, tile, seed):
    """Inputs, outputs (in the plain version's order), plain results, a
    launch through ctypes and the block count of one kernel at the main
    path's shapes."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from libdwt_torch.ops import fused as F

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((H, W), dtype=np.float32)).cuda()
    P = F._lift_params(F.get_wavelet(WV), False, kid in ("B4", "B5", "B6"))
    info = (ctypes.c_int * 2)()
    if kid in ("B1", "B4"):
        bands = [a.contiguous() for a in F.dwt2_level_plain(x, WV, tile)]
        if kid == "B1":
            ins, outs, want = [x], F._carve([tuple(a.shape) for a in bands], x), bands
        else:
            ins = bands
            outs = [torch.empty((H, W), device="cuda")]
            want = [F.idwt2_level_plain(*bands, WV, tile)]
        args = [t.data_ptr() for t in ins + outs] + [H, W, tile, 0]
        blocks = -(-W // (2 * tile)) * -(-H // (2 * tile))
    elif kid in ("B2", "B5"):
        ll2, b2, b1 = F.fused_dwt2_2level_plain(x, WV)
        if kid == "B2":
            ins = [x]
            outs = [torch.empty((H // 4, W // 4), device="cuda") for _ in range(4)]
            outs += [torch.empty((H // 2, W // 2), device="cuda") for _ in range(3)]
            want = cs.leaves(F.fused_dwt2_2level_plain(x, WV, tile))
        else:
            ins = [a.contiguous() for a in (ll2, *b2, *b1)]
            outs = [torch.empty((H, W), device="cuda")]
            want = [F.fused_idwt2_2level_plain(ins[0], tuple(ins[1:4]), tuple(ins[4:]), WV,
                                               tile)]
        args = [t.data_ptr() for t in ins + outs] + [H, W, tile]
        blocks = -(-W // tile) * -(-H // tile)
    else:
        ll2 = F.fused_dwt2_2level_plain(x, WV)[0].contiguous()
        coeffs = F.fused_deep_wavedec2_plain(ll2, WV, DEEP_LEVELS)
        shapes, ins = [], [ll2]
        if kid == "B3":
            h, w = ll2.shape
            for _ in range(DEEP_LEVELS):
                cy, cx, fy, fx = -(-h // 2), -(-w // 2), h // 2, w // 2
                shapes += [(cy, fx), (fy, cx), (fy, fx), (cy, cx)]  # HL, LH, HH, LL
                h, w = cy, cx
            made = F._carve(shapes, ll2)
            ptrs = ins + made
            outs = [made[-1]] + [a for k in reversed(range(DEEP_LEVELS))
                                 for a in made[4 * k: 4 * k + 3]]
            want = cs.leaves(coeffs)
            h, w = ll2.shape
        else:
            ins = [coeffs[0].contiguous()]
            h, w = ins[0].shape
            for hl, lh, _ in coeffs[1:]:
                h, w = h + lh.shape[0], w + hl.shape[1]
                shapes.append((h, w))
            made = F._carve(shapes, ll2)
            ptrs = list(ins)
            for bands, rec in zip(coeffs[1:], made):
                bands = [b.contiguous() for b in bands]
                ins += bands
                ptrs += bands + [rec]
            outs = [made[-1]]
            want = [F.fused_deep_waverec2_plain(coeffs, WV)]
        arr = (ctypes.c_void_p * len(ptrs))(*[t.data_ptr() for t in ptrs])
        args = [arr, DEEP_LEVELS, h, w, tile, info]
        blocks = None
    stream = torch.cuda.current_stream().cuda_stream

    def launch(fn):
        return fn(*args, ctypes.byref(P), stream)

    return {"ins": ins, "outs": outs, "want": want, "launch": launch, "P": P, "tile": tile,
            "nblocks": lambda: blocks if blocks is not None else info[0],
            "rounds": 1 if blocks is not None else DEEP_LEVELS}


def build(kid, spec, rounds):
    """Start nvcc on the stamped copy of the kernel's source; returns
    (process, library path)."""
    from libdwt_torch.ops import _cuda

    bdir = os.path.join(ROOT, "build", "kernel_phases", kid)
    os.makedirs(bdir, exist_ok=True)
    stem = os.path.splitext(spec["source"])[0]
    src = os.path.join(bdir, f"{stem}_phases.cu")
    body = ""
    if "body" in spec:  # the stamped header sits beside the source, found first
        with open(os.path.join(_cuda.CSRC, spec["body"][0])) as f:
            body = f.read()
    with open(os.path.join(_cuda.CSRC, spec["source"])) as f:
        text, stamped_body = stamped_source(f.read(), spec, rounds, body)
    with open(src, "w") as f:
        f.write(text)
    if body:
        with open(os.path.join(bdir, spec["body"][0]), "w") as f:
            f.write(stamped_body)
    lib = os.path.join(bdir, f"{stem}_phases.so")
    cmd = [_cuda.find_nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-o", lib, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


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


def report(kid, spec, case, lib, smi):
    """Run the stamped copy, check it, and print its phases."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from libdwt_torch.ops import _cuda

    phases, np_, rounds = spec["phases"], len(spec["phases"]), case["rounds"]
    nstamp = 1 + rounds * np_
    slots = nstamp + 3
    sym = f"{spec['entry']}_f32"
    pfn = getattr(lib, sym)
    pfn.argtypes = _cuda._SIGS[spec["entry"]]
    pfn.restype = ctypes.c_int
    for o in case["outs"]:
        o.zero_()
    for _ in range(3):
        _cuda.check(lib.kp_clear(MAX_BLOCKS * slots), "kp_clear")
        _cuda.check(case["launch"](pfn), f"stamped {sym}")
    torch.cuda.synchronize()
    if cs.max_abs(case["outs"], case["want"]) != 0:
        raise SystemExit(f"the stamped {kid} differs from its plain version")
    nblk = case["nblocks"]()
    if nblk > MAX_BLOCKS:
        raise SystemExit(f"{nblk} blocks: raise MAX_BLOCKS")
    buf = (ctypes.c_ulonglong * (MAX_BLOCKS * slots))()
    if lib.kp_read(buf, len(buf)) != 0:
        raise SystemExit("could not read the stamps")
    a = np.frombuffer(buf, dtype=np.uint64).reshape(MAX_BLOCKS, slots)[:nblk].astype(np.int64)
    print(f"{kid} phases of {nblk} blocks, clock64 cycles a block (a barrier before each "
          f"stamp) [{smi}]:")
    stamps = a[:, :nstamp]
    for r in range(rounds):
        for i, (_, name) in enumerate(phases):
            j = 1 + r * np_ + i
            ok = (stamps[:, j] > 0) & (stamps[:, j - 1] > 0)
            cyc = (stamps[:, j] - stamps[:, j - 1])[ok]
            label = f"level {r + 1} {name}" if rounds > 1 else name
            if len(cyc):
                print(f"  {label:22s} mean {cyc.mean():9.0f}  median {np.median(cyc):9.0f}"
                      f"  ({len(cyc)} blocks)")
            else:
                print(f"  {label:22s} no block ran it")
    total = stamps[:, nstamp - 1] - stamps[:, 0]
    print(f"  {'block, stamp 0 to last':22s} mean {total.mean():9.0f}  median "
          f"{np.median(total):9.0f}")
    start, end, sm = a[:, nstamp], a[:, nstamp + 1], a[:, nstamp + 2]
    print(f"block lifetime {(end - start).mean():.0f} ns mean (globaltimer); kernel span "
          f"{end.max() - start.min()} ns")
    most = most_resident(start, end, sm)
    print(f"{len(most)} SMs; most blocks resident on an SM at once: {max(most)} "
          f"(mean of the SMs' most {np.mean(most):.2f}); {nblk / len(most):.2f} blocks "
          f"an SM", flush=True)
    if "instance" in spec:
        occ, smem = ctypes.c_int(), window_smem(case["tile"])
        _cuda.check(lib.kp_occupancy(ctypes.byref(occ), THREADS, smem), "kp_occupancy")
        print(f"occupancy query: {occ.value} blocks of {THREADS} threads an SM at {smem} "
              f"bytes of shared memory (the stamped {spec['instance']})", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernels", nargs="*", default=["B3", "B6"], choices=sorted(KERNELS))
    ap.add_argument("--tile", type=int, default=0, help="default: the kernel's own")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from libdwt_torch.ops import _cuda

    smi = cs.nvidia_smi()
    cases, builds = {}, {}
    for kid in args.kernels:
        spec = KERNELS[kid]
        cases[kid] = make_case(kid, args.tile or spec["tile"], args.seed)
        builds[kid] = build(kid, spec, cases[kid]["rounds"])
    for kid, case in cases.items():
        spec = KERNELS[kid]
        fn = _cuda.kernel_fn(spec["entry"], "f32")
        _cuda.check(case["launch"](fn), spec["entry"])
        torch.cuda.synchronize()
        err = cs.max_abs(case["outs"], case["want"])
        if err != 0:
            raise SystemExit(f"{kid} differs from its plain version: max|diff| {err}")
        ms = cs.time_ms(lambda: case["launch"](fn), args.reps, warm=10)
        print(f"{kid} f32 {WV} tile {args.tile or spec['tile']} at the main path's shapes: "
              f"{ms:.4f} ms a launch (CUDA events, {args.reps} launches through ctypes), "
              f"== plain [{smi}]", flush=True)
    for kid, (proc, path) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the stamped {kid}:\n{log}")
        report(kid, KERNELS[kid], cases[kid], ctypes.CDLL(path), smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
