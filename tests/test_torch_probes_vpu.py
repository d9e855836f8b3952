"""The last probe kernels' plain PyTorch versions against the TPU probe
scripts' own Pallas functions in TPU interpret mode, on the same numpy
inputs from a seed:

- S1/S10, the scripts' ``lane_shuffle`` (profile_true.py,
  profile_shuffle.py), against B2's plain version: bit-equal;
- S2/S11, ``sub_shuffle`` and ``sub_gather`` for M in {8, 64, 512},
  against ``sub_gather_plain``: bit-equal;
- S4, ``chain``, against ``elementwise_plain("chain32")`` at rtol 1e-5
  (XLA contracts its step into an FMA, torch's eager ops round twice);
- S5, ``mk(body)`` for each body, against ``elementwise_plain``:
  bit-equal, bf16 included; with -0.0, inf and NaN inputs too, the NaN
  positions matching, except that XLA folds cmpmul16's multiply by a
  0/1 into a select, so the script's inf * 0 is not NaN;
- S6, ``redrow``, against ``block_rowsum_plain`` at rtol 1e-5, atol
  1e-5 (another summation order).

Also the new wrappers' refusals, their CPU path, ``bit_equal``, and
that the probes draw the scripts' arrays in the scripts' order.  The
scripts are never imported (they benchmark at import): their functions
are loaded with ``ast`` by tests/test_torch_probes.py's
``_script_functions``.  The CUDA kernels cannot run here; chip_smoke.py's
``probes`` phase holds each one against its plain version on the H100.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_probes import _interpret, _script_functions

from lux_tpu_torch.ops.block_rowsum import block_rowsum, block_rowsum_plain
from lux_tpu_torch.ops.chunk_reduce import KernelInputError
from lux_tpu_torch.ops.elementwise import (BODIES, elementwise,
                                           elementwise_plain)
from lux_tpu_torch.ops.lane_shuffle import lane_shuffle, lane_shuffle_plain
from lux_tpu_torch.ops.sub_gather import MAX_M, sub_gather, sub_gather_plain
from lux_tpu_torch.probes import ProbeCheckError, bit_equal

TOL = dict(rtol=1e-5, atol=1e-5)


def _bits(a):
    """The bytes of an array (bf16 included), for bit-equality."""
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8)


def _assert_bit_equal(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("script,kw", [
    ("profile_true.py", {}), ("profile_shuffle.py", {"bm": 512}),
    ("profile_shuffle.py", {"bm": 2048})])
def test_lane_shuffle_matches_script(script, kw):
    """S1 and S10 are B2's function for ids in [0, 128)."""
    R = 4096
    rng = np.random.default_rng(len(kw) + kw.get("bm", 0))
    x = rng.random((R, 128), np.float32)
    idx = rng.integers(0, 128, (R, 128)).astype(np.int32)
    fn = _script_functions(script, R=R)["lane_shuffle"]
    want = _interpret(fn, x, idx, **kw)
    _assert_bit_equal(lane_shuffle_plain(_t(x), _t(idx)), want)


@pytest.mark.parametrize("script,M", [
    ("profile_true.py", 8), ("profile_shuffle.py", 8),
    ("profile_shuffle.py", 64), ("profile_shuffle.py", 512)])
def test_sub_gather_matches_script(script, M):
    R = 1024
    rng = np.random.default_rng(M)
    x = rng.random((R, 128), np.float32)
    idx = rng.integers(0, M, (R, 128)).astype(np.int32)
    idx[0] = 0
    idx[1] = M - 1
    ns = _script_functions(script, R=R)
    if script == "profile_true.py":
        want = _interpret(ns["sub_shuffle"], x, idx)
    else:
        want = _interpret(ns["sub_gather"], x, idx, M=M)
    _assert_bit_equal(sub_gather_plain(_t(x), _t(idx), M), want)


def test_sub_gather_moves_words():
    """int32 words over the full range and f32 NaN payloads come
    through the plain version unchanged."""
    rng = np.random.default_rng(5)
    words = rng.integers(-2**31, 2**31, (64, 128)).astype(np.int32)
    idx = rng.integers(0, 8, (64, 128)).astype(np.int32)
    want = np.take_along_axis(words.reshape(8, 8, 128),
                              idx.reshape(8, 8, 128), axis=1).reshape(64, 128)
    got = sub_gather_plain(_t(words), _t(idx), 8)
    np.testing.assert_array_equal(got.numpy(), want)
    nan = _t(words).view(torch.float32)
    assert torch.isnan(nan).any()
    _assert_bit_equal(sub_gather_plain(nan, _t(idx), 8).view(torch.int32),
                      want)


@pytest.mark.parametrize("seed", [0, 1])
def test_chain_matches_script(seed):
    R = 2048
    x = np.random.default_rng(seed).random((R, 128), np.float32)
    want = _interpret(_script_functions("profile_true.py", R=R)["chain"], x)
    got = elementwise_plain("chain32", _t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _vpu_inputs(body, dtype, seed, special):
    N = 2048
    rng = np.random.default_rng(seed)
    x = rng.random((N, 128), np.float32)
    r = rng.integers(0, 128, (N, 128)).astype(np.int32)
    r[:, :4] = rng.integers(0, 16, (N, 4))      # the compares hit often
    if special:
        x[::7, 3] = -0.0
        x[1::7, 5] = np.inf
        x[2::7, 9] = np.nan
        x[3::7, 11] = -2.5e38                   # overflows in the chains
    if body == "chain32":
        return (x,)
    if body in ("cmpsel16", "cmpmul16"):
        return (x, r)
    if dtype == "bfloat16":
        xb = _t(x).to(torch.bfloat16)
        return (xb, xb)
    return (x, x)


def _vpu_body(ns, body):
    if body == "add":
        return lambda a, b: a + b               # profile_vpu.py:63
    return ns[body]


@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("body,dtype", [
    ("add", "float32"), ("chain10", "float32"), ("chain10", "bfloat16"),
    ("cmpsel16", "float32"), ("cmpmul16", "float32")])
def test_vpu_bodies_match_script(body, dtype, special):
    """mk(body) in interpret mode against the plain version, bit-equal:
    with -0.0, inf and NaN inputs the NaN positions match and every
    other word is bit-equal."""
    ns = _script_functions("profile_vpu.py", N=2048)
    ins = _vpu_inputs(body, dtype, 3, special)
    tins = [a if isinstance(a, torch.Tensor) else _t(a) for a in ins]
    got = elementwise_plain(body, *tins)
    jins = [a.view(torch.int16).numpy().view(jnp.bfloat16)
            if isinstance(a, torch.Tensor) else a for a in ins]
    want = np.asarray(_interpret(ns["mk"](_vpu_body(ns, body)), *jins))
    got = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    want = want.astype(np.float32)
    assert np.isnan(got).any() == special
    if body == "cmpmul16" and special:
        # XLA folds v * (r == wd) into a select, so where v is inf or
        # NaN the script gives 0 or inf; IEEE gives inf * 0 = NaN, as
        # torch's eager ops (and the CUDA kernel) do
        bad = ~np.isfinite(ins[0])
        assert np.isnan(got[bad]).all() and not np.isnan(want[bad]).all()
        got, want = got[~bad], want[~bad]
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_bits(np.where(nan, 0, got)),
                                  _bits(np.where(nan, 0, want)))


def test_redrow_matches_script():
    N = 2048
    x = np.random.default_rng(4).random((N, 128), np.float32)
    want = _interpret(_script_functions("profile_vpu.py", N=N)["redrow"], x)
    got = block_rowsum_plain(_t(x)).numpy()
    assert got.shape == (N // 1024, 128)
    np.testing.assert_allclose(got, want, **TOL)


def test_block_rowsum_other_bm():
    x = torch.from_numpy(np.random.default_rng(6).random((74, 128),
                                                        np.float32)) - 0.5
    got = block_rowsum_plain(x, 37)
    want = x.double().view(2, 37, 128).sum(dim=1)
    torch.testing.assert_close(got.double(), want, **TOL)
    assert torch.equal(block_rowsum_plain(x, 1), x)


def test_chain32_rounds_twice():
    """The plain chain32 is torch's eager mul then add (two roundings),
    the form the CUDA kernel's __fmul_rn / __fadd_rn reproduce."""
    v = _t(np.random.default_rng(8).random(4096, np.float32))
    acc = v.double()
    c = float(np.float32(1.0000001))
    for _ in range(32):
        acc = (acc * c).float().double()
        acc = (acc + v.double()).float().double()
    assert torch.equal(elementwise_plain("chain32", v), acc.float())


def test_wrappers_on_cpu_take_plain_versions():
    rng = np.random.default_rng(9)
    x = _t(rng.random((2048, 128), np.float32))
    r = _t(rng.integers(0, 128, (2048, 128)).astype(np.int32))
    i8 = _t(rng.integers(0, 8, (2048, 128)).astype(np.int32))
    cases = [(lane_shuffle, (x, r), lane_shuffle_plain(x, r)),
             (sub_gather, (x, i8, 8), sub_gather_plain(x, i8, 8)),
             (block_rowsum, (x,), block_rowsum_plain(x))]
    for body, (_, types) in BODIES.items():
        for dtype, (b_dtype, _) in types.items():
            a = x.to(dtype)
            b = None if b_dtype is None else (r if b_dtype == torch.int32
                                              else a)
            args = (body, a) if b is None else (body, a, b)
            cases.append((elementwise, args, elementwise_plain(*args)))
    for fn, args, want in cases:
        before = fn.launches
        got = fn(*args)
        assert fn.launches == before          # no kernel launched
        assert torch.equal(got, want)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# each call takes (x [64, 128] f32, idx [64, 128] int32 in [0, 8)) and
# must raise KernelInputError
BAD_CALLS = {
    "sub_gather/R_mod_M": lambda x, i: sub_gather(x, i, 3),
    "sub_gather/M0": lambda x, i: sub_gather(x, i, 0),
    "sub_gather/M_over_max": lambda x, i: sub_gather(
        torch.zeros((MAX_M + 1, 128)),
        torch.zeros((MAX_M + 1, 128), dtype=torch.int32), MAX_M + 1),
    "sub_gather/f64_x": lambda x, i: sub_gather(x.double(), i, 8),
    "sub_gather/int64_idx": lambda x, i: sub_gather(x, i.long(), 8),
    "sub_gather/narrow": lambda x, i: sub_gather(x[:, :64], i[:, :64], 8),
    "sub_gather/idx_shape": lambda x, i: sub_gather(x, i[:56], 8),
    "sub_gather/devices": lambda x, i: sub_gather(
        x, _meta(64, 128, dtype=torch.int32), 8),
    "sub_gather/meta": lambda x, i: sub_gather(
        _meta(64, 128), _meta(64, 128, dtype=torch.int32), 8),
    "elementwise/unknown": lambda x, i: elementwise("mul", x, x),
    "elementwise/int32_a": lambda x, i: elementwise("add", i, i),
    "elementwise/f64_a": lambda x, i: elementwise("chain10", x.double(),
                                                  x.double()),
    "elementwise/mixed": lambda x, i: elementwise(
        "chain10", x, x.to(torch.bfloat16)),
    "elementwise/one_input": lambda x, i: elementwise("add", x),
    "elementwise/chain32_two": lambda x, i: elementwise("chain32", x, x),
    "elementwise/f32_r": lambda x, i: elementwise("cmpsel16", x, x),
    "elementwise/shape": lambda x, i: elementwise("cmpmul16", x, i[:32]),
    "elementwise/devices": lambda x, i: elementwise(
        "add", x, _meta(64, 128)),
    "elementwise/meta": lambda x, i: elementwise("chain32", _meta(64, 128)),
    "block_rowsum/R_mod_bm": lambda x, i: block_rowsum(x, 48),
    "block_rowsum/bm0": lambda x, i: block_rowsum(x, 0),
    "block_rowsum/f64": lambda x, i: block_rowsum(x.double(), 8),
    "block_rowsum/narrow": lambda x, i: block_rowsum(x[:, :64], 8),
    "block_rowsum/1d": lambda x, i: block_rowsum(x.reshape(-1), 8),
    "block_rowsum/meta": lambda x, i: block_rowsum(_meta(64, 128), 8),
}


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_wrappers_refuse_typed(case):
    rng = np.random.default_rng(12)
    x = _t(rng.random((64, 128), np.float32))
    idx = _t(rng.integers(0, 8, (64, 128)).astype(np.int32))
    with pytest.raises(KernelInputError):
        BAD_CALLS[case](x, idx)


def test_bit_equal():
    a = torch.tensor([1.0, -0.0, float("nan")])
    assert bit_equal(a, a.clone()) == 0.0
    for other in (torch.tensor([1.0, 0.0, float("nan")]), a.double(), a[:2],
                  a.view(torch.int32).add(1).view(torch.float32)):
        with pytest.raises(ProbeCheckError):
            bit_equal(a, other)


def test_probes_draw_in_script_order():
    """make_inputs draws the scripts' arrays in the scripts' order (here
    at the small shapes)."""
    from lux_tpu_torch.probes import profile_shuffle, profile_true, \
        profile_vpu
    s = profile_true.SMALL
    rng = np.random.default_rng(0)
    want = [rng.random(s["V"], np.float32),
            rng.integers(0, s["V"], s["N"]).astype(np.int32),
            rng.random((s["R"], 128), np.float32),
            rng.integers(0, 128, (s["R"], 128)).astype(np.int32),
            rng.integers(0, 8, (s["R"], 128)).astype(np.int32),
            rng.random(s["XT"], np.float32),
            rng.random((s["E"], s["NB"] * 128), np.float32),
            np.sort(rng.integers(0, 128, (s["E"], s["NB"] * 128)),
                    axis=0).astype(np.int32)]
    got = profile_true.make_inputs(small=True)
    for w, key in zip(want, ("table0", "idx", "x0", "sidx", "sidx8", "xt0",
                             "vals0", "rel")):
        np.testing.assert_array_equal(got[key], w)
    s = profile_shuffle.SMALL
    rng = np.random.default_rng(0)
    got = profile_shuffle.make_inputs(small=True)
    np.testing.assert_array_equal(got["x"], rng.random((s["R"], 128),
                                                       np.float32))
    np.testing.assert_array_equal(got["idx1"],
                                  rng.integers(0, 128, (s["R"], 128)))
    for m in (8, 64, 512, 4096):
        np.testing.assert_array_equal(got[f"idx0_{m}"],
                                      rng.integers(0, m, (s["R"], 128)))
    np.testing.assert_array_equal(got["xt"], rng.random(s["XT"], np.float32))
    n = profile_vpu.SMALL_N
    rng = np.random.default_rng(0)
    got = profile_vpu.make_inputs(small=True)
    np.testing.assert_array_equal(got["x"], rng.random((n, 128), np.float32))
    np.testing.assert_array_equal(got["r"], rng.integers(0, 128, (n, 128)))
