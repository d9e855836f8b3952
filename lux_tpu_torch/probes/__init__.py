"""The port's counterparts of the TPU probe scripts, named after them.

    python3 -m lux_tpu_torch.probes.profile_kernel [--3d] [--device cpu] \
        [--small]
    python3 -m lux_tpu_torch.probes.profile_slotted [--scale S] \
        [--device cpu] [--small]
    python3 -m lux_tpu_torch.probes.profile_v3 [--device cpu] [--small]
    python3 -m lux_tpu_torch.probes.profile_true [--device cpu] [--small]
    python3 -m lux_tpu_torch.probes.profile_shuffle [--device cpu] \
        [--small]
    python3 -m lux_tpu_torch.probes.profile_vpu [--device cpu] [--small]

Each runs the port's kernels at its script's shapes and seed
(``np.random.default_rng(0)``, drawn in the script's own order), prints
the script's own lines (ms and the script's rate, the median of
``repeats`` samples of ``loop_bench``) and one JSON line, and returns
that line's dict.  The default device is the card; ``--device cpu``
runs the plain versions (host-clock times of PyTorch's CPU ops, no
device metric) and ``--small`` cuts the shapes for a quick run.
Nothing runs at import.
"""

from __future__ import annotations

import argparse

import torch

from lux_tpu_torch.timing import loop_bench, median_mad

REPS = 10           # calls a sample, as the scripts' REPS
REPEATS = 3         # samples, as the scripts' loop_bench(repeats=3)
TOL = dict(rtol=1e-5, atol=1e-5)   # kernel vs plain, values in [0, 1)


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain versions)")
    ap.add_argument("--small", action="store_true",
                    help="cut the shapes for a quick run")
    return ap


def timeit(name: str, fn, work: int, unit: str, width: int,
           device, per: float = 1e9) -> dict:
    """Median seconds a call of ``fn`` (``loop_bench``, ``REPEATS``
    samples of ``REPS`` calls), printed as the scripts print it:
    ms and ``work`` / seconds / ``per`` in ``unit``."""
    samples = loop_bench(fn, REPS, repeats=REPEATS, device=device)
    dt, mad = median_mad(samples)
    print(f"{name:{width}s} {dt * 1e3:8.2f} ms  ({work / dt / per:6.2f} "
          f"{unit})", flush=True)
    return {"name": name, "ms": dt * 1e3, "mad_ms": mad * 1e3,
            "rate": work / dt / per, "unit": unit}


class ProbeCheckError(RuntimeError):
    """A kernel's output disagrees with its plain version."""


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want|, raising ``ProbeCheckError`` when it breaks
    ``TOL`` or the shapes differ (a probe checks its kernel's output
    before it reports the kernel's time)."""
    if got.shape != want.shape:
        raise ProbeCheckError(f"shape {tuple(got.shape)} vs "
                              f"{tuple(want.shape)}")
    diff = (got.double() - want.double()).abs()
    bound = TOL["atol"] + TOL["rtol"] * want.double().abs()
    if not bool((diff <= bound).all()):
        raise ProbeCheckError(f"kernel disagrees with its plain version: "
                              f"max abs err {float(diff.max())} "
                              f"(rtol 1e-5, atol 1e-5)")
    return float(diff.max()) if diff.numel() else 0.0


def bit_equal(got: torch.Tensor, want: torch.Tensor) -> float:
    """0.0 when ``got`` holds the same bits as ``want`` (dtype, shape
    and every byte, NaN payloads included), else ``ProbeCheckError``:
    the check of a kernel that moves bits or rounds as its plain
    version does."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise ProbeCheckError(f"{got.dtype} {tuple(got.shape)} vs "
                              f"{want.dtype} {tuple(want.shape)}")
    if not torch.equal(got.reshape(-1).view(torch.uint8),
                       want.reshape(-1).view(torch.uint8)):
        raise ProbeCheckError("kernel is not bit-equal to its plain "
                              "version")
    return 0.0
