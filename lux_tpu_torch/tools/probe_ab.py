"""A/B of the launch plans of S2/S11 ``sub_gather`` and S9
``onehot_reduce`` on the card.

    python3 -m lux_tpu_torch.tools.probe_ab [--rounds 5] [--reps 20]
        [--old-csrc DIR] [--only sub_gather|onehot] [--ablate]

At the probe scripts' shapes and seed (profile_shuffle.py's [262,144 x
128] at M = 8, 64, 512 and 4,096; profile_kernel.py's [81,920 x 512],
W = 128), every variant is first held to the plain version (bit for
bit for the gather, rtol/atol 1e-5 for the reduce), then all are timed
in turns (CUDA events around ``--reps`` calls, the order reversed
every other round), beside one library call (``torch.gather`` with
int64 ids made outside the timed call; ``scatter_add`` over
[C, W + 1]) and, for S9, kernel B1 at the same shape.

Variants: ``sub_gather`` plans (ops/sub_gather.py ``plan``): the
default, "direct", "staged" at 64 KB, 128 KB and 227 KB a CTA (each
distinct plan once); ``onehot_reduce`` as it is.  ``--old-csrc DIR``
also builds DIR/sub_gather.cu and DIR/onehot_mma.cu, the designs
these replace, with their C interfaces (``OLD_ABI``) and times them in
the same turns; ``--ablate`` builds onehot_mma.cu with other
register budgets (``bps2``, ``bps4``: blocks an SM, checked) and with
one part of its work taken out each (``no_*``: no mma, no one-hot
compares, no bf16 conversions, no copies of the values and lanes;
unchecked, their answers are wrong) and times those too: where the
time goes.

Prints the card's name and power limit, the ptxas lines of the builds,
then one JSON line a shape: each variant's median ms, its per-round ms
and its ratio to the default plan.  Needs a card and nvcc; it writes
its builds under lux_tpu_torch/_build.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
# the C interfaces of the replaced designs
OLD_ABI = {"sub_gather.cu": ("lux_sub_gather",
                             [_P, _P, _P, _I64, _I32, _P]),
           "onehot_mma.cu": ("lux_onehot_reduce",
                             [_P, _P, _P, _I64, _I64, _I32, _P])}


def build_old(csrc: str) -> dict:
    """{source name: ctypes function} of the replaced designs in
    ``csrc``, one nvcc each, started together."""
    from pathlib import Path

    from lux_tpu_torch import _kernels
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in OLD_ABI:
        lib = _kernels.BUILD_DIR / f"old_{Path(src).stem}.so"
        procs[src] = (subprocess.Popen(
            [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", str(lib),
             str(Path(csrc) / src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    out = {}
    for src, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        print(f"old {src}: " + "; ".join(sorted(
            {ln.split(":", 1)[-1].strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln})), flush=True)
        name, argtypes = OLD_ABI[src]
        fn = getattr(ctypes.CDLL(str(lib)), name)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
        out[src] = fn
    return out


# onehot_mma.cu with one part of the work taken out each (no_*: timing
# only, the answers are wrong) or another register budget (bps*:
# blocks an SM in __launch_bounds__); anchored edits that must apply
# exactly once
ABLATIONS = {
    "no_mma": [('  asm volatile(\n      "mma.sync',
                '  d[0] += __uint_as_float(a0 ^ a1 ^ a2 ^ a3 ^ b0 ^ b1);\n'
                '  if (false) asm volatile(\n      "mma.sync')],
    "no_onehot": [("  return as_u32(__heq2(as_bf2(a), as_bf2(b)));",
                   "  return a ^ b;")],
    "no_split": [("  return as_u32(__floats2bfloat162_rn(a, b));",
                  "  return __float_as_uint(a) ^ __float_as_uint(b);")],
    "no_copy": [("          cp_async16(raw + e, v + e);\n"
                 "          cp_async16(raw + kStage + e, r + e);\n", "")],
    # launch-bound variants, checked like the default
    "bps2": [("constexpr int kBlocksPerSm = 3;",
              "constexpr int kBlocksPerSm = 2;")],
    "bps4": [("constexpr int kBlocksPerSm = 3;",
              "constexpr int kBlocksPerSm = 4;")],
}


def build_ablations(ptxas: list) -> dict:
    """{name: ctypes lux_onehot_reduce} of each ABLATIONS build, one
    nvcc each, started together."""
    from lux_tpu_torch import _kernels
    src_name, fns = _kernels.KERNELS["onehot_reduce"]
    text = (_kernels.CSRC / src_name).read_text()
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in ABLATIONS.items():
        t = text
        for anchor, repl in edits:
            if t.count(anchor) != 1:
                raise ValueError(f"{name}: anchor found {t.count(anchor)} "
                                 f"times, want 1: {anchor!r}")
            t = t.replace(anchor, repl)
        src = _kernels.BUILD_DIR / f"onehot_ab_{name}.cu"
        src.write_text(t)
        lib = src.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), lib)
    out = {}
    restype, argtypes = fns["lux_onehot_reduce"]
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        ptxas.append(f"{name}: " + "; ".join(sorted(
            {ln.split(":", 1)[-1].strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln})))
        fn = ctypes.CDLL(str(lib)).lux_onehot_reduce
        fn.restype, fn.argtypes = restype, argtypes
        out[name] = fn
    return out


def call_old(torch, fn, out, *args):
    """Launch a replaced design's C function into ``out``."""
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"old kernel launch failed: cudaError_t {err}")
    return out


def in_turns(torch, forms: dict, rounds: int, reps: int) -> dict:
    """{name: [ms a round]}: CUDA events around ``reps`` calls of each
    form, the forms in turns, the order reversed every other round."""
    names = list(forms)
    times = {k: [] for k in names}
    for k in names:                       # warm-up
        forms[k]()
    torch.cuda.synchronize()
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                forms[k]()
            end.record()
            end.synchronize()
            times[k].append(start.elapsed_time(end) / reps)
    return times


def summary(times: dict, base: str) -> dict:
    med = {k: statistics.median(v) for k, v in times.items()}
    return {k: {"ms": med[k], "rounds": v, "vs_default": med[k] / med[base]}
            for k, v in times.items()}


def sub_gather_ab(torch, args, old) -> list:
    from lux_tpu_torch.ops.sub_gather import (KernelInputError, SMEM_BYTES,
                                              plan, sub_gather,
                                              sub_gather_plain)
    from lux_tpu_torch.probes import profile_shuffle
    dev = torch.device("cuda")
    h = profile_shuffle.make_inputs()
    x = torch.from_numpy(h["x"]).to(dev)
    R = x.shape[0]
    lines = []
    for M in profile_shuffle.MS:
        idx = torch.from_numpy(h[f"idx0_{M}"]).to(dev)
        want = sub_gather_plain(x, idx, M)
        plans = {"default": plan(M)}
        tries = [("direct", ("direct",), {}), ("staged_64k", ("staged",), {}),
                 ("staged_128k", ("staged", 128 * 1024), {}),
                 ("staged_227k", ("staged", SMEM_BYTES), {})]
        for name, a, kw in tries:
            try:
                p = plan(M, *a, **kw)
            except KernelInputError:      # no such plan at this M
                continue
            if p not in plans.values():
                plans[name] = p
        forms = {k: (lambda p=p: sub_gather(x, idx, M, plan_override=p))
                 for k, p in plans.items()}
        if old:
            out = torch.empty_like(x)
            forms["replaced"] = lambda: call_old(
                torch, old["sub_gather.cu"], out, x.data_ptr(),
                idx.data_ptr(), out.data_ptr(), R, M)
        idx64 = idx.long().view(R // M, M, 128)
        xv = x.view(R // M, M, 128)
        for k, f in forms.items():
            got = f()
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32),
                               want.view(torch.int32)):
                raise RuntimeError(f"sub_gather {k} at M={M} is not "
                                   f"bit-equal to the plain version")
        forms["torch.gather"] = lambda: torch.gather(xv, 1, idx64)
        times = in_turns(torch, forms, args.rounds, args.reps)
        line = {"kernel": "sub_gather", "M": M, "shape": [R, 128],
                "bound_ms": R * 128 * 12 / 3.35e12 * 1e3,
                "plans": plans, "variants": summary(times, "default")}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def onehot_ab(torch, args, old) -> dict:
    from lux_tpu_torch.ops.chunk_reduce import chunk_partials
    from lux_tpu_torch.ops.onehot_reduce import (onehot_reduce,
                                                 onehot_reduce_plain)
    from lux_tpu_torch.probes import profile_kernel
    from lux_tpu_torch.probes import max_abs_err
    dev = torch.device("cuda")
    h = profile_kernel.make_inputs()
    vals = torch.from_numpy(h["vals"]).to(dev)
    rel = torch.from_numpy(h["rel"]).to(dev)
    C, E = vals.shape
    W = profile_kernel.W
    want = onehot_reduce_plain(vals, rel, W)
    ab_ptxas = []
    forms = {"default": lambda: onehot_reduce(vals, rel, W)}
    if old:
        out = torch.empty((C, W), device=dev)
        forms["replaced"] = lambda: call_old(
            torch, old["onehot_mma.cu"], out, vals.data_ptr(),
            rel.data_ptr(), out.data_ptr(), C, E, W)
    builds = build_ablations(ab_ptxas) if args.ablate else {}
    for name, fn in builds.items():
        o = torch.empty((C, W), device=dev)
        forms[f"ablate_{name}"] = lambda fn=fn, o=o: call_old(
            torch, fn, o, vals.data_ptr(), rel.data_ptr(), o.data_ptr(), C,
            E, W)
    errs = {}
    for k, f in forms.items():
        if not k.startswith("ablate_no_"):    # raises past rtol/atol 1e-5
            errs[k] = max_abs_err(f(), want)
    rel8 = torch.where((rel >= 0) & (rel < W), rel, -1).to(torch.int8)
    lane = torch.where((rel >= 0) & (rel < W), rel, W).long()
    flat_idx = (torch.arange(C, device=dev)[:, None] * (W + 1)
                + lane).reshape(-1)
    flat_vals = vals.reshape(-1)
    base = torch.zeros(C * (W + 1), device=dev)
    forms["b1"] = lambda: chunk_partials(vals, rel8, W, "sum")
    forms["scatter_add"] = lambda: base.scatter_add(0, flat_idx, flat_vals)
    times = in_turns(torch, forms, args.rounds, args.reps)
    for ln in ab_ptxas:
        print(ln, flush=True)
    line = {"kernel": "onehot_reduce", "shape": [C, E, W],
            "bound_ms": C * (8 * E + 4 * W) / 3.35e12 * 1e3,
            "max_abs_err": errs, "variants": summary(times, "default")}
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--old-csrc", default=None)
    ap.add_argument("--only", choices=("sub_gather", "onehot"))
    ap.add_argument("--ablate", action="store_true",
                    help="also time onehot_mma.cu with one part of its "
                         "work taken out each (ABLATIONS; wrong answers)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("error: probe_ab needs an NVIDIA card", file=sys.stderr)
        return 1
    from lux_tpu_torch import _kernels
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    for name, rep in _kernels.build(["sub_gather", "onehot_reduce",
                                     "chunk_partials"]).items():
        print(f"{name}: " + "; ".join(sorted(
            {ln.split(":", 1)[-1].strip() for ln in rep["ptxas"].splitlines()
             if "registers" in ln or "spill" in ln})), flush=True)
    old = build_old(args.old_csrc) if args.old_csrc else {}
    if args.only != "onehot":
        sub_gather_ab(torch, args, old)
    if args.only != "sub_gather":
        onehot_ab(torch, args, old)
    return 0


if __name__ == "__main__":
    sys.exit(main())
