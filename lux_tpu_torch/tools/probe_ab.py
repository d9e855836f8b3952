"""A/B of the launch plans and variants of the redesigned probe kernels
on the card: S2/S11 ``sub_gather``, S9 ``onehot_reduce``, S3/S12
``transposed_reduce`` and S4/S5 ``elementwise``.

    python3 -m lux_tpu_torch.tools.probe_ab [--rounds 5] [--reps 20]
        [--old-csrc DIR]
        [--only sub_gather|onehot|transposed|elementwise] [--ablate]

At the probe scripts' shapes and seed (profile_shuffle.py's [262,144 x
128] at M = 8, 64, 512 and 4,096; profile_kernel.py's [81,920 x 512],
W = 128; profile_v3.py's [512 x 65,536], W = 128; profile_vpu.py's
[524,288 x 128] and profile_true.py's [262,144 x 128]), every variant
is first held to the plain version (bit for bit for the gather and the
elementwise bodies, rtol/atol 1e-5 for the reduces), then all are
timed in turns (CUDA events around ``--reps`` calls, the order
reversed every other round), beside one library call
(``torch.gather`` with int64 ids made outside the timed call;
``scatter_add`` over [C, W + 1] or along dim 0 into [W + 1, N];
``torch.add(x, x)`` and a plain copy ``out.copy_(x)``) and, for S9,
kernel B1 at the same shape.

Variants: ``sub_gather`` plans (ops/sub_gather.py ``plan``): the
default, "direct", "staged" at 64 KB, 128 KB and 227 KB a CTA (each
distinct plan once); ``onehot_reduce`` as it is; ``transposed_reduce``
through its wrapper at the scripts' wg 8, 16, 32 and at 128 (one
launch: wg does not change it); ``elementwise``, each body, its build
called raw and through its wrapper.  ``--old-csrc DIR`` also builds the
sources in DIR that these designs replace (sub_gather.cu,
onehot_mma.cu, transposed_reduce.cu, elementwise.cu) with their C
interfaces (OLD_ABI) and times them in the same turns;
``--ablate`` builds onehot_mma.cu with other register budgets
(``bps2``, ``bps4``: blocks an SM, checked) and with one part of its
work taken out each (``no_*``: no mma, no one-hot compares, no bf16
conversions, no copies of the values and lanes; unchecked, their
answers are wrong) and times those too: where the time goes.

Prints the card's name and power limit, the ptxas lines of the builds,
then one JSON line a shape: each variant's median ms, its per-round ms
and its ratio to the default.  Needs a card and nvcc; it writes its
builds under lux_tpu_torch/_build.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
# the C interfaces of the replaced designs, by the --only choice that
# times them
OLD_ABI = {"sub_gather.cu": ("sub_gather", "lux_sub_gather",
                             [_P, _P, _P, _I64, _I32, _P]),
           "onehot_mma.cu": ("onehot", "lux_onehot_reduce",
                             [_P, _P, _P, _I64, _I64, _I32, _P]),
           "transposed_reduce.cu": ("transposed", "lux_transposed_reduce",
                                    [_P, _P, _P, _I64, _I64, _I32, _I32,
                                     _P]),
           "elementwise.cu": ("elementwise", "lux_elementwise",
                              [_I32, _P, _P, _P, _I64, _P])}
CHOICES = ("sub_gather", "onehot", "transposed", "elementwise")


def compile_all(jobs: dict, ptxas: list) -> dict:
    """{name: ctypes.CDLL} for jobs {name: (source, library)}: one nvcc
    each with the port's flags, started together; each build's ptxas
    lines go to ``ptxas``."""
    from lux_tpu_torch import _kernels
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_kernels.nvcc_path(), *_kernels.NVCC_FLAGS, "-o", str(lib),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, (src, lib) in jobs.items()}
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        ptxas.append(f"{name}: " + "; ".join(sorted(
            {ln.split(":", 1)[-1].strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln})))
        out[name] = ctypes.CDLL(str(jobs[name][1]))
    return out


def bind(lib, name: str, restype, argtypes):
    fn = getattr(lib, name)
    fn.restype, fn.argtypes = restype, argtypes
    return fn


def build_old(csrc: str, only) -> dict:
    """{source name: ctypes function} of the replaced designs in
    ``csrc`` (those ``only`` times; all when None), one nvcc each,
    started together."""
    from pathlib import Path

    from lux_tpu_torch import _kernels
    srcs = [src for src, (choice, _, _) in OLD_ABI.items()
            if only in (None, choice)]
    ptxas = []
    libs = compile_all({src: (Path(csrc) / src,
                              _kernels.BUILD_DIR / f"old_{Path(src).stem}.so")
                        for src in srcs}, ptxas)
    for ln in ptxas:
        print(f"old {ln}", flush=True)
    return {src: bind(libs[src], OLD_ABI[src][1], ctypes.c_int,
                      OLD_ABI[src][2]) for src in srcs}


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


def variant_source(text: str, edits: list) -> str:
    """``text`` with each (anchor, replacement) of ``edits`` applied;
    each anchor must occur exactly once."""
    for anchor, repl in edits:
        if text.count(anchor) != 1:
            raise ValueError(f"anchor found {text.count(anchor)} times, "
                             f"want 1: {anchor!r}")
        text = text.replace(anchor, repl)
    return text


def build_ablations(ptxas: list) -> dict:
    """{name: ctypes lux_onehot_reduce} of each ABLATIONS build, one
    nvcc each, started together."""
    from lux_tpu_torch import _kernels
    src_name, fns = _kernels.KERNELS["onehot_reduce"]
    text = (_kernels.CSRC / src_name).read_text()
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, edits in ABLATIONS.items():
        src = _kernels.BUILD_DIR / f"onehot_ab_{name}.cu"
        src.write_text(variant_source(text, edits))
        jobs[name] = (src, src.with_suffix(".so"))
    libs = compile_all(jobs, ptxas)
    restype, argtypes = fns["lux_onehot_reduce"]
    return {name: bind(libs[name], "lux_onehot_reduce", restype, argtypes)
            for name in ABLATIONS}


def call_old(torch, fn, out, *args):
    """Launch a replaced design's C function into ``out``."""
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"old kernel launch failed: cudaError_t {err}")
    return out


def in_turns(torch, forms: dict, rounds: int, reps: int) -> dict:
    """{name: [ms a round]}: CUDA events around ``reps`` calls of each
    form, the forms in turns, the order reversed every other round.  One
    call of the form is enqueued before the start event, so the card is
    busy when timing starts and the host's time to reach the first
    launch (larger through a Python wrapper) is not counted."""
    names = list(forms)
    times = {k: [] for k in names}
    for k in names:                       # warm-up
        forms[k]()
    torch.cuda.synchronize()
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            forms[k]()
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


def transposed_ab(torch, args, old) -> dict:
    from lux_tpu_torch.ops.transposed_reduce import (transposed_reduce,
                                                     transposed_reduce_plain)
    from lux_tpu_torch.probes import max_abs_err, profile_v3
    dev = torch.device("cuda")
    h = profile_v3.make_inputs()
    vals = torch.from_numpy(h["vals"]).to(dev)
    rel = torch.from_numpy(h["rel"]).to(dev)
    E, N = vals.shape
    W = profile_v3.W
    want = transposed_reduce_plain(vals, rel, W)
    forms = {f"wg{wg}": (lambda wg=wg: transposed_reduce(vals, rel, W, wg))
             for wg in profile_v3.WGS}
    if old:
        for wg in profile_v3.WGS:
            o = torch.empty((W, N), device=dev)
            forms[f"replaced_wg{wg}"] = lambda wg=wg, o=o: call_old(
                torch, old["transposed_reduce.cu"], o, vals.data_ptr(),
                rel.data_ptr(), o.data_ptr(), E, N, W, wg)
    errs = {k: max_abs_err(f(), want) for k, f in forms.items()}
    again = forms["wg8"]()
    torch.cuda.synchronize()
    if not torch.equal(again.view(torch.int32),
                       forms["wg128"]().view(torch.int32)):
        raise RuntimeError("transposed_reduce: two launches differ")
    idx = torch.where((rel >= 0) & (rel < W), rel, W).long()
    base = torch.zeros((W + 1, N), device=dev)
    forms["scatter_add"] = lambda: base.scatter_add(0, idx, vals)
    times = in_turns(torch, forms, args.rounds, args.reps)
    line = {"kernel": "transposed_reduce", "shape": [E, N, W],
            "bound_ms": (8 * E + 4 * W) * N / 3.35e12 * 1e3,
            "max_abs_err": errs, "variants": summary(times, "wg128")}
    print(json.dumps(line), flush=True)
    return line


def elementwise_ab(torch, args, old) -> list:
    from lux_tpu_torch import _kernels
    from lux_tpu_torch.ops.elementwise import (BODIES, elementwise,
                                               elementwise_plain)
    from lux_tpu_torch.probes import profile_true, profile_vpu
    dev = torch.device("cuda")
    hv = profile_vpu.make_inputs()
    vx = torch.from_numpy(hv["x"]).to(dev)
    vr = torch.from_numpy(hv["r"]).to(dev)
    x0 = torch.from_numpy(profile_true.make_inputs()["x0"]).to(dev)
    vxb = vx.to(torch.bfloat16)
    lib_fn = _kernels.load("elementwise").lux_elementwise
    lines = []
    for name, body, a, b in (("add", "add", vx, vx),
                             ("chain10", "chain10", vx, vx),
                             ("chain10_bf16", "chain10", vxb, vxb),
                             ("cmpsel16", "cmpsel16", vx, vr),
                             ("cmpmul16", "cmpmul16", vx, vr),
                             ("chain32", "chain32", x0, None)):
        body_id = BODIES[body][1][a.dtype][1]
        want = elementwise_plain(body, a, b)
        bb = a if b is None else b

        def raw(fn, o):
            return lambda: call_old(torch, fn, o, body_id, a.data_ptr(),
                                    bb.data_ptr(), o.data_ptr(), a.numel())
        # the default build called raw into one output buffer, and
        # through its wrapper (a new output a call, as torch.add)
        forms = {"default": raw(lib_fn, torch.empty_like(a)),
                 "wrapper": lambda: elementwise(body, a, b)}
        if old:
            forms["replaced"] = raw(old["elementwise.cu"],
                                    torch.empty_like(a))
        for k, f in forms.items():
            got = f()
            torch.cuda.synchronize()
            words = torch.int32 if a.element_size() == 4 else torch.int16
            if not torch.equal(got.view(words), want.view(words)):
                raise RuntimeError(f"elementwise {name} {k} is not "
                                   f"bit-equal to the plain version")
        if name == "add":
            out = torch.empty_like(a)
            forms["torch.add"] = lambda: torch.add(a, a)
            forms["torch.add_out"] = lambda: torch.add(a, a, out=out)
            forms["copy_"] = lambda: out.copy_(a)
        n_bytes = sum(t.numel() * t.element_size()
                      for t in {t.data_ptr(): t for t in (a, bb)}.values())
        n_bytes += a.numel() * a.element_size()
        times = in_turns(torch, forms, args.rounds, args.reps)
        line = {"kernel": "elementwise", "body": name,
                "shape": list(a.shape),
                "dtype": str(a.dtype).replace("torch.", ""),
                "bound_ms": n_bytes / 3.35e12 * 1e3,
                "variants": summary(times, "default")}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--old-csrc", default=None)
    ap.add_argument("--only", choices=CHOICES)
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
                                     "chunk_partials", "transposed_reduce",
                                     "elementwise"]).items():
        print(f"{name}: " + "; ".join(sorted(
            {ln.split(":", 1)[-1].strip() for ln in rep["ptxas"].splitlines()
             if "registers" in ln or "spill" in ln})), flush=True)
    old = build_old(args.old_csrc, args.only) if args.old_csrc else {}
    runs = {"sub_gather": sub_gather_ab, "onehot": onehot_ab,
            "transposed": transposed_ab, "elementwise": elementwise_ab}
    for choice in CHOICES:
        if args.only in (None, choice):
            runs[choice](torch, args, old)
    return 0


if __name__ == "__main__":
    sys.exit(main())
