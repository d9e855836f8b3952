"""The probe kernels' plain PyTorch versions (S7 carry_combine, S8
fused_carry, S9 onehot_reduce, S3/S12 transposed_reduce) against the
TPU probe scripts' own Pallas functions in TPU interpret mode, on the
same numpy inputs, at rtol 1e-5 and atol 1e-5 (values in [0, 1); the
scripts sum in f32 in their own order, the plain versions in f32 or
f64 in another).  Also the wrappers on the CPU, every probe's entry
point at ``--device cpu --small``, and ``loop_bench`` / ``median_mad``.
The other probe kernels' parity tests (S1/S10, S2/S11, S4/S5, S6) are
in tests/test_torch_probes_vpu.py, which loads the scripts with this
file's ``_script_functions``.

The scripts run their benchmarks at import, so they are never
imported: ``_script_functions`` parses a script, keeps only the named
top-level functions and runs them with small globals (C, E, W, NB).
The CUDA kernels cannot run here (no nvcc, no card); chip_smoke.py's
``probes`` phase holds each one against its plain version on the H100.
"""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lux_tpu_torch.device import DeviceUnavailableError
from lux_tpu_torch.ops.carry import (carry_combine, carry_combine_plain,
                                     fused_carry, fused_carry_plain)
from lux_tpu_torch.ops.chunk_reduce import KernelInputError
from lux_tpu_torch.ops.onehot_reduce import (mma_count, onehot_reduce,
                                             onehot_reduce_plain)
from lux_tpu_torch.ops.transposed_reduce import (transposed_reduce,
                                                 transposed_reduce_plain)
from lux_tpu_torch.timing import loop_bench, median_mad

SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
TOL = dict(rtol=1e-5, atol=1e-5)

# script -> (the functions the parity tests load, the wrappers among
# them: each must reach pallas_call; profile_vpu.py's ``run`` is nested
# in ``mk``)
FUNCTIONS = {
    "profile_slotted.py": (("_carry_kernel", "carry"), ("carry",)),
    "profile_kernel.py": (("_fused_kernel", "fused", "_mxu_kernel", "mxu"),
                          ("fused", "mxu")),
    "profile_v3.py": (("kernel", "reduce_v3"), ("reduce_v3",)),
    "profile_true.py": (("v3_kernel", "v3", "shuffle_kernel", "lane_shuffle",
                         "sub_kernel", "sub_shuffle", "chain_kernel",
                         "chain"),
                        ("v3", "lane_shuffle", "sub_shuffle", "chain")),
    "profile_shuffle.py": (("shuffle_kernel", "lane_shuffle", "sub_kernel",
                            "sub_gather"), ("lane_shuffle", "sub_gather")),
    "profile_vpu.py": (("mk", "chain10", "cmpsel16", "cmpmul16",
                        "redrow_kern", "redrow"), ("mk", "redrow")),
}


def _script_functions(script: str, **consts) -> dict:
    """The named top-level functions of ``scripts/<script>`` (and no
    other statement of it), defined in a namespace holding jax, jnp,
    pl, pltpu, functools and ``consts``."""
    path = SCRIPTS / script
    tree = ast.parse(path.read_text(), filename=str(path))
    names = FUNCTIONS[script][0]
    defs = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu,
          "functools": functools, **consts}
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(path), "exec"),
         ns)
    return ns


def _interpret(fn, *args, **kw):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*(jnp.asarray(a) for a in args), **kw))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("script", sorted(FUNCTIONS))
def test_loader_finds_each_function(script):
    names, wrapper_names = FUNCTIONS[script]
    ns = _script_functions(script, C=8, E=8, W=128, NB=1)
    for name in names:
        assert callable(ns.get(name)), f"{script} has no function {name}"
    # each wrapper still reaches pallas_call
    src = (SCRIPTS / script).read_text()
    tree = ast.parse(src)
    wrappers = [n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name in wrapper_names]
    assert len(wrappers) == len(wrapper_names)
    for fn in wrappers:
        assert "pallas_call" in ast.get_source_segment(src, fn)


def _starts(rng, C, p, first):
    st = (rng.random(C) < p).astype(np.int32)
    st[0] = first
    return st.reshape(C, 1)


@pytest.mark.parametrize("first", [0, 1])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_carry_matches_script(seed, first):
    C, W, bc = 64, 128, 16
    rng = np.random.default_rng(seed)
    part = rng.random((C, W), np.float32)
    start = _starts(rng, C, 0.3, first)
    ns = _script_functions("profile_slotted.py", C=C, W=W)
    want = _interpret(ns["carry"], part, start, bc=bc)
    got = carry_combine_plain(torch.from_numpy(part), torch.from_numpy(start))
    _close(got, want)


def test_carry_ragged_grid_rows():
    """C not a multiple of the script's block: its grid covers only the
    first C // bc * bc rows; those agree, and the port computes all."""
    C, W, bc = 72, 128, 16
    rng = np.random.default_rng(7)
    part = rng.random((C, W), np.float32)
    start = _starts(rng, C, 0.3, 0)
    ns = _script_functions("profile_slotted.py", C=C, W=W)
    want = _interpret(ns["carry"], part, start, bc=bc)
    got = carry_combine_plain(torch.from_numpy(part),
                              torch.from_numpy(start)).numpy()
    covered = C // bc * bc
    _close(got[:covered], want[:covered])
    acc = got[covered - 1].astype(np.float64)
    for i in range(covered, C):
        acc = part[i] if start[i, 0] == 1 else acc + part[i]
        _close(got[i], acc)


def test_carry_plain_definition():
    """Only 1 marks a start, the carry before row 0 is 0, and a [C]
    start is the same as the scripts' [C, 1]."""
    part = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    start = torch.tensor([0, 1, 2, 0, 1, 1], dtype=torch.int32)
    out = carry_combine_plain(part, start)
    assert out.tolist() == [[0, 1], [2, 3], [6, 8], [12, 15], [8, 9],
                            [10, 11]]
    assert torch.equal(out, carry_combine_plain(part, start.reshape(6, 1)))


def _chunks(rng, C, E, W, sort):
    vals = rng.random((C, E), np.float32)
    rel = rng.integers(0, W + 1, (C, E))      # W is the scripts' pad
    if sort:
        rel = np.sort(rel, axis=1)
    return vals, rel.astype(np.int32)


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("first", [0, 1])
@pytest.mark.parametrize("seed,W", [(0, 128), (1, 128), (2, 40)])
def test_fused_carry_matches_script(seed, W, first, sort):
    C, E, bc = 64, 16, 16
    rng = np.random.default_rng(seed)
    vals, rel = _chunks(rng, C, E, W, sort)
    start = _starts(rng, C, 0.2, first)
    ns = _script_functions("profile_kernel.py", C=C, E=E, W=W)
    want = _interpret(ns["fused"], vals, rel, start, bc=bc)
    got = fused_carry_plain(torch.from_numpy(vals), torch.from_numpy(rel),
                            torch.from_numpy(start), W)
    _close(got, want)


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("seed,W", [(0, 128), (1, 128), (2, 40)])
def test_onehot_matches_script(seed, W, sort, monkeypatch):
    from lux_tpu_torch.ops import onehot_reduce as mod
    monkeypatch.setattr(mod, "PLAIN_BLOCK", 24)   # 3 blocks, one ragged
    C, E, bc = 64, 16, 16
    rng = np.random.default_rng(seed)
    vals, rel = _chunks(rng, C, E, W, sort)
    ns = _script_functions("profile_kernel.py", C=C, E=E, W=W)
    want = _interpret(ns["mxu"], vals, rel, bc=bc)
    got = onehot_reduce_plain(torch.from_numpy(vals), torch.from_numpy(rel),
                              W)
    _close(got, want)


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("wg", [8, 16])
def test_reduce_v3_matches_script(wg, sort):
    E, W, NB = 16, 128, 2
    rng = np.random.default_rng(wg + sort)
    vals = rng.random((E, NB * 128), np.float32)
    rel = rng.integers(0, W, (E, NB * 128))
    if sort:
        rel = np.sort(rel, axis=0)
    rel = rel.astype(np.int32)
    ns = _script_functions("profile_v3.py", E=E, W=W, NB=NB)
    want = _interpret(ns["reduce_v3"], vals, rel, wg=wg)
    got = transposed_reduce_plain(torch.from_numpy(vals),
                                  torch.from_numpy(rel), W)
    _close(got, want)


def test_v3_of_profile_true_matches():
    """S3 (profile_true.py's v3) computes S12's function: lanes past W
    and columns that hit few rows included."""
    E, NB, W = 16, 2, 128
    rng = np.random.default_rng(3)
    vals = rng.random((E, NB * 128), np.float32)
    rel = rng.integers(0, W + 4, (E, NB * 128)).astype(np.int32)
    rel[:, ::5] = rng.integers(0, 3, (E, len(range(0, NB * 128, 5))))
    ns = _script_functions("profile_true.py", E=E, NB=NB)
    want = _interpret(ns["v3"], vals, rel)
    got = transposed_reduce_plain(torch.from_numpy(vals),
                                  torch.from_numpy(rel), W).numpy()
    _close(got, want)
    assert (got[3:, ::5] == 0).all()


def test_transposed_empty_rows_are_zero():
    vals = torch.ones((3, 4))
    rel = torch.tensor([[0, -1, 5, 2], [0, -1, 1, 2], [9, -1, 1, 2]],
                       dtype=torch.int32)
    out = transposed_reduce_plain(vals, rel, 4)
    assert out.tolist() == [[2, 0, 0, 0], [0, 0, 2, 0], [0, 0, 0, 3],
                            [0, 0, 0, 0]]


def test_mma_count():
    """Three mma a (chunk, 16-entry k-step), one a bf16 part: pad steps
    and lanes outside W included, whatever W is."""
    rel = torch.full((2, 40), -1, dtype=torch.int32)
    rel[0, 0] = 3          # step 0
    rel[0, 39] = 127       # step 2 (the padded tail)
    rel[1, 16] = 128       # outside W
    assert mma_count(rel, 128) == 2 * 3 * 3
    assert mma_count(rel, 16) == 2 * 3 * 3
    assert mma_count(rel[:, :16], 128) == 2 * 1 * 3
    assert mma_count(rel[:1, :1], 1) == 3


def _wrapper_inputs(rng, C=40, E=24, W=128):
    vals, rel = _chunks(rng, C, E, W, sort=False)
    start = _starts(rng, C, 0.3, 0)
    return (torch.from_numpy(vals), torch.from_numpy(rel),
            torch.from_numpy(start))


def test_wrappers_on_cpu_take_plain_versions():
    rng = np.random.default_rng(11)
    vals, rel, start = _wrapper_inputs(rng)
    part = torch.from_numpy(rng.random((40, 128), np.float32))
    tv, tr = vals.T.contiguous(), rel.T.contiguous()
    cases = [
        (carry_combine, (part, start), carry_combine_plain(part, start)),
        (fused_carry, (vals, rel, start, 128),
         fused_carry_plain(vals, rel, start, 128)),
        (onehot_reduce, (vals, rel, 128), onehot_reduce_plain(vals, rel, 128)),
        (transposed_reduce, (tv, tr, 128, 8),
         transposed_reduce_plain(tv, tr, 128)),
    ]
    for fn, args, want in cases:
        before = fn.launches
        got = fn(*args)
        assert fn.launches == before          # no kernel launched
        assert torch.equal(got, want)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# each call takes (vals [C, E] f32, rel [C, E] int32, start [C, 1] int32,
# part [C, 16] f32) and must raise KernelInputError
BAD_CALLS = {
    "carry/f64_part": lambda v, r, s, p: carry_combine(p.double(), s),
    "carry/f32_start": lambda v, r, s, p: carry_combine(p, s.float()),
    "carry/int64_start": lambda v, r, s, p: carry_combine(p, s.long()),
    "carry/short_start": lambda v, r, s, p: carry_combine(p, s[:-1]),
    "carry/wide_start": lambda v, r, s, p: carry_combine(p, s.repeat(1, 2)),
    "carry/part_1d": lambda v, r, s, p: carry_combine(p[:, 0], s),
    "carry/part_W0": lambda v, r, s, p: carry_combine(p[:, :0], s),
    "carry/part_3d": lambda v, r, s, p: carry_combine(p.reshape(40, 4, 4),
                                                      s),
    "carry/non_contiguous_part": lambda v, r, s, p: carry_combine(
        _meta(16, 40).T, _meta(40, dtype=torch.int32)),
    "carry/non_contiguous_start": lambda v, r, s, p: carry_combine(
        _meta(40, 16), _meta(40, 2, dtype=torch.int32)[:, 0]),
    "carry/devices": lambda v, r, s, p: carry_combine(
        p, _meta(40, dtype=torch.int32)),
    "fused/f64_vals": lambda v, r, s, p: fused_carry(v.double(), r, s, 128),
    "fused/int64_rel": lambda v, r, s, p: fused_carry(v, r.long(), s, 128),
    "fused/int8_rel": lambda v, r, s, p: fused_carry(
        v, r.to(torch.int8), s, 128),
    "fused/f32_start": lambda v, r, s, p: fused_carry(v, r, s.float(), 128),
    "fused/rel_shape": lambda v, r, s, p: fused_carry(v, r[:, 1:], s, 128),
    "fused/W129": lambda v, r, s, p: fused_carry(v, r, s, 129),
    "onehot/f64_vals": lambda v, r, s, p: onehot_reduce(v.double(), r, 128),
    "onehot/int64_rel": lambda v, r, s, p: onehot_reduce(v, r.long(), 128),
    "onehot/W0": lambda v, r, s, p: onehot_reduce(v, r, 0),
    "transposed/f64_vals": lambda v, r, s, p: transposed_reduce(
        v.double(), r, 128),
    "transposed/int8_rel": lambda v, r, s, p: transposed_reduce(
        v, r.to(torch.int8), 128),
    "transposed/W129": lambda v, r, s, p: transposed_reduce(v, r, 129),
    "transposed/wg0": lambda v, r, s, p: transposed_reduce(v, r, 128, 0),
    "transposed/wg_over_W": lambda v, r, s, p: transposed_reduce(v, r, 64,
                                                                 65),
}


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_wrappers_refuse_typed(case):
    vals, rel, start = _wrapper_inputs(np.random.default_rng(12))
    with pytest.raises(KernelInputError):
        BAD_CALLS[case](vals, rel, start, vals[:, :16].contiguous())


@pytest.mark.parametrize("probe,argv", [
    ("profile_kernel", ["--3d"]), ("profile_slotted", []),
    ("profile_v3", []), ("profile_true", []), ("profile_shuffle", []),
    ("profile_vpu", [])])
def test_probe_main_on_cpu_small(probe, argv, capsys):
    import importlib
    mod = importlib.import_module(f"lux_tpu_torch.probes.{probe}")
    res = mod.main([*argv, "--device", "cpu", "--small"])
    assert res["probe"] == probe and res["device"] == "cpu"
    assert res["lines"] and all(ln["ms"] > 0 for ln in res["lines"])
    checked = [ln for ln in res["lines"] if "max_abs_err" in ln]
    assert checked and all(ln["max_abs_err"] == 0.0 for ln in checked)
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("{") and " ms  (" in out[0] + out[2]


@pytest.mark.parametrize("probe", ["profile_kernel", "profile_slotted",
                                   "profile_v3", "profile_true",
                                   "profile_shuffle", "profile_vpu"])
def test_probe_default_device_needs_cuda(probe, monkeypatch):
    import importlib
    mod = importlib.import_module(f"lux_tpu_torch.probes.{probe}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        mod.main(["--small"])


def test_median_mad():
    assert median_mad([3.0, 1.0, 2.0, 10.0]) == (2.5, 1.0)
    assert median_mad([4.0]) == (4.0, 0.0)
    with pytest.raises(ValueError):
        median_mad([])


def test_loop_bench_on_cpu(monkeypatch):
    calls = []
    samples = loop_bench(lambda: calls.append(1), 5, repeats=4,
                         device="cpu")
    assert len(samples) == 4 and all(s >= 0 for s in samples)
    assert len(calls) == 1 + 5 * 4            # one warm-up call
    with pytest.raises(ValueError):
        loop_bench(lambda: None, 0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        loop_bench(lambda: None, 1)           # the default is the card
