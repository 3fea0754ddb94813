"""Where a bf16 forward tile's cycles go: kernels B1 bf16 and B3 bf16.

    python3 nerf_shared_tpu_torch/benchmarks/bf16_tile_probe.py [--tree DIR] [--out FILE]

Copies ``DIR/nerf_shared_tpu_torch/csrc`` (default: this checkout's) into
``build/bf16_tile_probe/``, inserts ``clock64()`` stamps into the copy of
the bf16 tile at fixed anchors, builds the copy's ``fused_mlp.cu`` with
``-DNSTT_TILE_PROBE`` and runs its bf16 entries at the lego width on seeded
weights: B1 bf16 at 196,608 points (1024 rays x 192) and B3 bf16 at 32,768
rays x 192. The kernels the port launches are built from the sources as
they are and carry no stamp; the probe also runs them, holds the stamped
build's outputs bit for bit against theirs and times both (CUDA events).

Lane 0 of every warp adds the cycles of each region to a per-warp slot in
shared memory; the slots are summed over the launch. A category's figure
is its mean cycles per warp per tile, and its share of the tile's cycles
(``tile``: the whole tile). Two tiles are understood: ``mlp_tile_bf16.cuh``
and, in a checkout from before it (``--tree``), the bf16 branch
(``kBf16``) of ``mlp_tile_tc.cuh``'s ``tile_network``; the copy's anchors
are checked, and the probe fails if one is missing. The report goes to
``--out`` (default ``build/bf16_tile_probe/<tree>.json``) and, as one JSON
line, to stdout. Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# category index -> name; the stamps below add to these
CATS = ["ring", "a_operand", "mma", "epilogue", "heads", "rows", "tile", "tiles", "out",
        "kernel", "encoder", "producer_wait"]
N_SLOTS = 16
REPS = 5   # launches a timing

PROLOGUE = r"""
#ifdef NSTT_TILE_PROBE
__device__ unsigned long long probe_sum[16];
__device__ __forceinline__ unsigned* probe_slot() {
  __shared__ unsigned slots[12][12];
  return slots[threadIdx.x >> 5];
}
__device__ __forceinline__ void probe_add(int cat, long long t0) {
  if ((threadIdx.x & 31) == 0) probe_slot()[cat] += (unsigned)(clock64() - t0);
}
__device__ __forceinline__ void probe_count(int cat) {
  if ((threadIdx.x & 31) == 0) probe_slot()[cat] += 1;
}
__device__ __forceinline__ void probe_init() {
  if ((threadIdx.x & 31) == 0)
    for (int i = 0; i < 12; ++i) probe_slot()[i] = 0;
}
__device__ __forceinline__ void probe_flush() {
  if ((threadIdx.x & 31) == 0)
    for (int i = 0; i < 12; ++i) atomicAdd(probe_sum + i, (unsigned long long)probe_slot()[i]);
}
#endif
"""

ENTRIES = r"""
extern "C" int nstt_probe_reset() {
  unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(nstt::NS::probe_sum, z, sizeof z);
}
extern "C" int nstt_probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, nstt::NS::probe_sum, 16 * sizeof(unsigned long long));
}
extern "C" int nstt_probe_clock_khz() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrClockRate, dev);
  return v;
}
"""


# (file, anchor, replacement) for the parent's bf16 branch of tile_network
TC_PATCHES = [
    ("mlp_tile_tc.cuh", "constexpr int NACC = 64;        // accumulators a thread per m64 block (N <= 128)\n",
     "constexpr int NACC = 64;        // accumulators a thread per m64 block (N <= 128)\n" + PROLOGUE),
    ("mlp_tile_tc.cuh", "      const float* slice = acquire<kBf16>(r, d, wb);\n",
     "      const long long _pa = clock64();\n      const float* slice = acquire<kBf16>(r, d, wb);\n"
     "      probe_add(0, _pa);\n"),
    ("mlp_tile_tc.cuh",
     "        unsigned a[2][4];\n#pragma unroll\n"
     "        for (int m = 0; m < 2; ++m) a_frag_bf16(d, e, s, src, k0, HS, m, a[m]);\n",
     "        const long long _pf = clock64();\n        unsigned a[2][4];\n#pragma unroll\n"
     "        for (int m = 0; m < 2; ++m) a_frag_bf16(d, e, s, src, k0, HS, m, a[m]);\n"
     "        probe_add(1, _pf);\n        const long long _pm = clock64();\n"),
    ("mlp_tile_tc.cuh", "          default: mma_slice_bf16<16>(acc, a, b); break;\n        }\n",
     "          default: mma_slice_bf16<16>(acc, a, b); break;\n        }\n"
     "        probe_add(2, _pm);\n"),
    ("mlp_tile_tc.cuh",
     "      release(r);\n    }\n"
     "    __syncthreads();   // every warp is done reading h before it is overwritten\n"
     "    epilogue<kBf16>(acc, wb + G[G_B], G[G_RELU] != 0, nh, n0, s.h, HS);\n"
     "    __syncthreads();\n",
     "      const long long _pr = clock64();\n      release(r);\n      probe_add(0, _pr);\n    }\n"
     "    const long long _pe = clock64();\n"
     "    __syncthreads();   // every warp is done reading h before it is overwritten\n"
     "    epilogue<kBf16>(acc, wb + G[G_B], G[G_RELU] != 0, nh, n0, s.h, HS);\n"
     "    __syncthreads();\n    probe_add(3, _pe);\n"),
    ("mlp_tile_tc.cuh", "  const int K = (int)Nh[NW_K], N = (int)Nh[NW_N], lane = threadIdx.x & 31;\n",
     "  const int K = (int)Nh[NW_K], N = (int)Nh[NW_N], lane = threadIdx.x & 31;\n"
     "  const long long _pn = clock64();\n"),
    ("mlp_tile_tc.cuh",
     "    if (lane == 0) raw[p * RAW_LD + col_off + o] = s + __ldg(bias + o);\n  }\n}\n",
     "    if (lane == 0) raw[p * RAW_LD + col_off + o] = s + __ldg(bias + o);\n  }\n"
     "  probe_add(4, _pn);\n}\n"),
    ("mlp_tile_tc.cuh",
     "  if (viewdirs) narrow(d.narrow[N_RGB], wb, s.h, HS, s.raw, 0);\n  __syncthreads();\n}\n",
     "  if (viewdirs) narrow(d.narrow[N_RGB], wb, s.h, HS, s.raw, 0);\n"
     "  const long long _pz = clock64();\n  __syncthreads();\n  probe_add(3, _pz);\n}\n"),
    ("mlp_tile_tc.cuh", "  __syncthreads();   // the tile's rows are set\n",
     "  const long long _ps = clock64();\n  __syncthreads();   // the tile's rows are set\n"
     "  probe_add(3, _ps);\n"),
    ("fused_mlp.cu", "  Ring ring = start_ring<kBf16>(d, wb, s.ring, bars, R, mine);\n",
     "  probe_init();\n  const long long _pk = clock64();\n"
     "  Ring ring = start_ring<kBf16>(d, wb, s.ring, bars, R, mine);\n"),
    ("fused_mlp.cu",
     "    tile_rows(d, e, p0, total, s);\n"
     "    tile_network<Enc, kSliceSums, kBf16>(d, wb, e, s, ring);\n",
     "    const long long _pt = clock64();\n    tile_rows(d, e, p0, total, s);\n"
     "    probe_add(5, _pt);\n    const long long _pw = clock64();\n"
     "    tile_network<Enc, kSliceSums, kBf16>(d, wb, e, s, ring);\n"
     "    probe_add(6, _pw);\n    probe_count(7);\n    const long long _po = clock64();\n"),
    ("fused_mlp.cu",
     "      if (gp < total) out[gp * OUT + o] = s.raw[q * RAW_LD + o];\n    }\n  }\n}\n",
     "      if (gp < total) out[gp * OUT + o] = s.raw[q * RAW_LD + o];\n    }\n"
     "    probe_add(8, _po);\n  }\n  probe_add(9, _pk);\n  probe_flush();\n}\n"),
]

# the same for mlp_tile_bf16.cuh: the consumer warps stamp (the
# producer thread does not); "ring" is the wait on a stage's full barrier,
# "mma" the rest of a GEMM's stage loop (issue, wait_group, release)
BF16_PATCHES = [
    ("mlp_tile_bf16.cuh", "constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;\n",
     "constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;\n" + PROLOGUE),
    ("mlp_tile_bf16.cuh", "    wait_parity(r.full + r.slot, r.phase);\n",
     "    const long long _pa = clock64();\n    wait_parity(r.full + r.slot, r.phase);\n"
     "    probe_add(0, _pa);\n    const long long _pm = clock64();\n"),
    ("mlp_tile_bf16.cuh", "    prev = r.slot;\n    advance(r);\n  }\n",
     "    prev = r.slot;\n    advance(r);\n    probe_add(2, _pm);\n  }\n"
     "  const long long _pl = clock64();\n"),
    ("mlp_tile_bf16.cuh", "  fence_acc<N>(acc);\n  release(r, prev);\n}\n",
     "  fence_acc<N>(acc);\n  release(r, prev);\n  probe_add(2, _pl);\n}\n"),
    ("mlp_tile_bf16.cuh",
     "    wg_sync(wg);   // every warp's MMAs have read h before it is overwritten\n",
     "    const long long _pe = clock64();\n"
     "    wg_sync(wg);   // every warp's MMAs have read h before it is overwritten\n"),
    ("mlp_tile_bf16.cuh", "    fence_to_mma();\n    wg_sync(wg);\n    if (gi == D - 1)\n",
     "    fence_to_mma();\n    wg_sync(wg);\n    probe_add(3, _pe);\n    if (gi == D - 1)\n"),
    ("mlp_tile_bf16.cuh", "  const int K = (int)Nh[tc::NW_K], N = (int)Nh[tc::NW_N];\n",
     "  const int K = (int)Nh[tc::NW_K], N = (int)Nh[tc::NW_N];\n"
     "  const long long _pn = clock64();\n"),
    ("mlp_tile_bf16.cuh",
     "    raw[(row0 + p) * RAW_LD + col_off + o] = s[0] + __ldg(bias + o);\n  }\n}\n",
     "    raw[(row0 + p) * RAW_LD + col_off + o] = s[0] + __ldg(bias + o);\n  }\n"
     "  probe_add(4, _pn);\n}\n"),
    ("mlp_tile_bf16.cuh", "  encode(d, e, s, wg, p0, pend);\n",
     "  const long long _pw = clock64();\n  const long long _pc = clock64();\n"
     "  encode(d, e, s, wg, p0, pend);\n  probe_add(10, _pc);\n"),
    ("mlp_tile_bf16.cuh",
     "  if (viewdirs) head(d.narrow[tc::N_RGB], wb, h, s.raw, WG_ROWS * wg, 0);\n"
     "  wg_sync(wg);\n}\n",
     "  if (viewdirs) head(d.narrow[tc::N_RGB], wb, h, s.raw, WG_ROWS * wg, 0);\n"
     "  wg_sync(wg);\n  probe_add(6, _pw);\n  probe_count(7);\n}\n"),
    ("mlp_tile_bf16.cuh", "        if (issued >= r.R) wait_parity(r.empty + r.slot, r.phase ^ 1);\n",
     "        const long long _pp = clock64();\n"
     "        if (issued >= r.R) wait_parity(r.empty + r.slot, r.phase ^ 1);\n"
     "        probe_add(11, _pp);\n"),
    ("mlp_tile_bf16.cuh", "    if (threadIdx.x == NCONS) produce_all(d, wb, r, ntiles);\n",
     "    if (threadIdx.x == NCONS) {\n      probe_init();\n      produce_all(d, wb, r, ntiles);\n"
     "      probe_flush();\n    }\n"),
    ("mlp_tile_bf16.cuh",
     "  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 %0;\" :: \"n\"(CONSUMER_REGS));\n",
     "  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 %0;\" :: \"n\"(CONSUMER_REGS));\n"
     "  probe_init();\n"),
    ("fused_mlp.cu", "    bf16::tile(d, wb, e, s, ring, wg, p0, total);\n",
     "    bf16::tile(d, wb, e, s, ring, wg, p0, total);\n"
     "    const long long _po = clock64();\n"),
    ("fused_mlp.cu",
     "      if (gp < total) out[gp * OUT + o] = s.raw[q * RAW_LD + o];\n    }\n  }\n}\n\n"
     "// B1: points",
     "      if (gp < total) out[gp * OUT + o] = s.raw[q * RAW_LD + o];\n    }\n"
     "    bf16::probe_add(8, _po);\n  }\n  bf16::probe_flush();\n}\n\n// B1: points"),
]


def patched_sources(tree: Path, dst: Path):
    """Copy ``tree``'s csrc to ``dst`` with the stamps in; returns which
    tile was stamped. Raises if an anchor is not found exactly once."""
    src = tree / "nerf_shared_tpu_torch" / "csrc"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    new = (dst / "mlp_tile_bf16.cuh").exists()
    patches = BF16_PATCHES if new else TC_PATCHES
    texts = {}
    for name, anchor, repl in patches:
        text = texts.get(name) or (dst / name).read_text()
        n = text.count(anchor)
        if n != 1:
            raise RuntimeError(f"probe anchor found {n} times in {name}: {anchor!r}")
        texts[name] = text.replace(anchor, repl)
    texts["fused_mlp.cu"] = (texts.get("fused_mlp.cu") or (dst / "fused_mlp.cu").read_text()) \
        + ENTRIES.replace("NS", "bf16" if new else "tc")
    for name, text in texts.items():
        (dst / name).write_text(text)
    return "mlp_tile_bf16.cuh" if new else "mlp_tile_tc.cuh kBf16"


def build_probe(tree: Path, work: Path):
    from nerf_shared_tpu_torch.ops.cuda import common

    csrc = work / "csrc"
    tile = patched_sources(tree, csrc)
    lib = work / "libfused_mlp_probe.so"
    cmd = [common._nvcc(), *common.NVCC_FLAGS, "-DNSTT_TILE_PROBE", "-o", str(lib),
           str(csrc / "fused_mlp.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"probe build failed:\n{proc.stdout}{proc.stderr}")
    regs = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(str(lib)), tile, regs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT), help="the checkout whose tile is stamped")
    ap.add_argument("--out", default=None,
                    help="the JSON report (default: build/bf16_tile_probe/<tree>.json)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bf16_tile_probe: no CUDA device", file=sys.stderr)
        return 1
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from nerf_shared_tpu_torch.benchmarks.fp32_digest import rays
    from nerf_shared_tpu_torch.models.nerf import NeRF, NeRFConfig
    from nerf_shared_tpu_torch.ops.cuda import fused_mlp

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    work = ROOT / "build" / "bf16_tile_probe" / tree.name
    out_path = args.out or str(work.parent / f"{tree.name}.json")
    lib, tile, regs = build_probe(tree, work)
    khz = lib.nstt_probe_clock_khz()
    bf = torch.bfloat16
    cfg = NeRFConfig(D=8, W=256, skips=(4,), use_viewdirs=True, multires=10, multires_views=4)
    params = {k: v.detach() for k, v in NeRF(
        cfg, device="cuda", generator=torch.Generator().manual_seed(19)).params().items()}
    dev = next(iter(params.values())).device
    wbuf, desc, HS, SLOT = fused_mlp.pack_network_tc(params, cfg, dev, bf)
    enc = fused_mlp.encoder_buffer(cfg, dev)
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    argtypes = [vp, ctypes.c_int, ctypes.c_int] + [vp] * 5 + [i64, ctypes.c_int, vp]
    main_lib = {"points": fused_mlp.common.load("fused_mlp", argtypes, "nstt_points_forward_bf16"),
                "rays": fused_mlp.common.load("fused_mlp", argtypes, "nstt_rays_forward_bf16")}
    for fn in (lib.nstt_points_forward_bf16, lib.nstt_rays_forward_bf16):
        fn.argtypes = argtypes
    # the entries' two sizes: (HS, SLOT) before mlp_tile_bf16.cuh, (SLOT, E) with it
    sizes = (SLOT, fused_mlp.tile_emb_cols(cfg)) if tile == "mlp_tile_bf16.cuh" else (HS, SLOT)
    results = {"card": smi, "tile": tile, "tree": str(tree), "sm_clock_khz": khz,
               "ptxas": regs, "cases": []}

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPS):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / REPS

    o, d, z, vd = rays(1024, 192, 1, "cuda")
    pts = (o[:, None] + d[:, None] * z[..., None]).contiguous()
    ro, rd, rz, rvd = rays(32768, 192, 2, "cuda")
    A, B = fused_mlp.ray_encoder_args(cfg, ro, rd, rvd)
    stream = torch.cuda.current_stream().cuda_stream

    def b1(fn, out):
        rc = fn(desc.data_ptr(), *sizes, wbuf.data_ptr(), enc.data_ptr(), pts.data_ptr(),
                vd.data_ptr(), out.data_ptr(), pts.numel() // 3, 192, stream)
        assert rc == 0, rc

    def b3(fn, out):
        rc = fn(desc.data_ptr(), *sizes, wbuf.data_ptr(), A.data_ptr(), B.data_ptr(),
                rz.data_ptr(), out.data_ptr(), 32768, 192, stream)
        assert rc == 0, rc

    cases = [("B1 bf16", 1024 * 192, b1, lib.nstt_points_forward_bf16, main_lib["points"],
              lambda: fused_mlp.launch_points(params, cfg, pts, vd, bf)),
             ("B3 bf16", 32768 * 192, b3, lib.nstt_rays_forward_bf16, main_lib["rays"],
              lambda: fused_mlp.fused_nerf_forward_rays(params, cfg, ro, rd, rz, rvd, bf))]
    with torch.no_grad():
        for label, n, run, stamped, unstamped, main_path in cases:
            out = torch.empty((n, 4), device="cuda")
            want = main_path()
            lib.nstt_probe_reset()
            run(stamped, out)
            torch.cuda.synchronize()
            sums = (ctypes.c_ulonglong * N_SLOTS)()
            assert lib.nstt_probe_read(sums) == 0
            same = bool(torch.equal(out.reshape(want.shape), want))
            t_probe = ms(lambda: run(stamped, out))
            t_kernel = ms(lambda: run(unstamped, out))
            t_main = ms(main_path)
            per = {c: sums[i] / max(1, sums[7]) for i, c in enumerate(CATS) if c != "tiles"}
            # the producer thread's waits: one warp of the eight consumer ones counted
            per["producer_wait"] *= 8
            tile_cyc = per["tile"]
            row = {"kernel": label, "points": n, "tiles": (n + 127) // 128,
                   "warp_tiles": sums[7], "stamped_equals_main_path": same,
                   "ms_main_path": t_main, "ms_kernel": t_kernel, "ms_stamped": t_probe,
                   "us_per_tile": 1e3 * tile_cyc / khz,
                   "cycles_per_tile": per,
                   "share_of_tile": {c: per[c] / tile_cyc for c in
                                     ("ring", "a_operand", "encoder", "mma", "epilogue",
                                      "heads", "producer_wait")}}
            results["cases"].append(row)
            print(f"{label} at {n} points ({smi}; {tile}): main path {t_main:.4f} ms, "
                  f"the kernel alone {t_kernel:.4f} ms, stamped {t_probe:.4f} ms, outputs "
                  f"equal: {same}; {row['us_per_tile']:.2f} "
                  f"us a tile at {khz / 1e3:.0f} MHz")
            for c in ("ring", "a_operand", "encoder", "mma", "epilogue", "heads", "rows",
                      "out", "tile", "kernel", "producer_wait"):
                if not per[c]:
                    continue
                share = per[c] / tile_cyc
                print(f"  {c:10s} {per[c]:12.0f} cycles a warp a tile  {100 * share:6.2f}%")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))
    return 0 if all(c["stamped_equals_main_path"] for c in results["cases"]) else 1


if __name__ == "__main__":
    sys.exit(main())
