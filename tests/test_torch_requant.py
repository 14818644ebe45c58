"""repro_torch.quant against repro.quant: requantization, multiplier
encoding and (de)quantization agree bit for bit."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.quant import QParams as RefQParams
from repro.quant import dequantize as ref_dequantize
from repro.quant import quantize as ref_quantize
from repro.quant import requant as ref
from repro_torch.quant import qtensor, requant

I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _accs() -> np.ndarray:
    rng = np.random.default_rng(0)
    edges = [I32_MIN, I32_MIN + 1, I32_MAX, I32_MAX - 1, 0, 1, -1]
    for e in (1 << 24, 1 << 23, 1 << 25):
        edges += [e - 1, e, e + 1, -e + 1, -e, -e - 1]
    return np.concatenate([
        np.array(edges, np.int64),
        np.arange(-512, 513),                     # dense ties at small shifts
        rng.integers(I32_MIN, I32_MAX, 400, endpoint=True),
        rng.integers(-(1 << 16), 1 << 16, 200),
    ]).astype(np.int32)


def _mults() -> np.ndarray:
    rng = np.random.default_rng(1)
    return np.concatenate([
        np.array([0, 1, 1 << 30, (1 << 30) + 1, I32_MAX, I32_MIN, -1]),
        rng.integers(1 << 30, I32_MAX, 4),
        rng.integers(I32_MIN, I32_MAX, 2),
    ]).astype(np.int32)


def _grid():
    """Every shift in [-31, 30] x the multipliers x the accumulators,
    flattened."""
    acc, mult, shift = np.meshgrid(_accs(), _mults(),
                                   np.arange(ref.SHIFT_MIN,
                                             ref.SHIFT_MAX + 1),
                                   indexing="ij")
    return (acc.ravel(), mult.ravel().astype(np.int32),
            shift.ravel().astype(np.int32))


def test_grid_hits_ties_and_saturation():
    acc, mult, shift = _grid()
    prod = acc.astype(object) * mult.astype(object)
    s = 31 - shift.astype(np.int64)
    ties = sum(1 for p, k in zip(prod[::7], s[::7])
               if p % (1 << int(k)) == 1 << (int(k) - 1))
    assert ties > 100
    want = np.asarray(ref.requantize_i32(acc, mult, shift))
    assert (np.abs(want) == 1 << 24).sum() > 1000


@pytest.mark.parametrize("fn", ["requantize_i32", "requantize"])
def test_requantize_bitwise_equals_reference(fn):
    acc, mult, shift = _grid()
    want = np.asarray(getattr(ref, fn)(acc, mult, shift))
    got = getattr(requant, fn)(torch.from_numpy(acc),
                               torch.from_numpy(mult),
                               torch.from_numpy(shift))
    np.testing.assert_array_equal(got.numpy().astype(want.dtype), want)
    if fn == "requantize":
        assert got.dtype == torch.int8


def test_requantize_scalar_constants_and_channel_broadcast():
    rng = np.random.default_rng(2)
    acc = rng.integers(-(1 << 20), 1 << 20, (5, 7, 9)).astype(np.int32)
    mult = rng.integers(1 << 30, I32_MAX, 9).astype(np.int32)
    shift = rng.integers(-14, -6, 9).astype(np.int32)
    want = np.asarray(ref.requantize(acc, mult[None, None], shift[None,
                                                                  None]))
    got = requant.requantize(torch.from_numpy(acc), torch.from_numpy(mult),
                             torch.from_numpy(shift))
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(ref.requantize(acc, 1288490189, -9))
    got = requant.requantize(torch.from_numpy(acc), 1288490189, -9)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("activation", [None, "identity", "relu"])
def test_act_i32_equals_reference(activation):
    acc = _accs()
    want = np.asarray(ref.act_i32(acc, activation))
    got = requant.act_i32(torch.from_numpy(acc), activation)
    np.testing.assert_array_equal(got.numpy(), want)


def test_act_i32_rejects_other_activations():
    with pytest.raises(NotImplementedError):
        requant.act_i32(torch.zeros(3, dtype=torch.int32), "gelu")


def test_quantize_multiplier_sweep_below_2_30():
    rng = np.random.default_rng(3)
    reals = np.concatenate([
        2.0 ** np.linspace(-31, 29.999, 4000),
        rng.uniform(0, 1, 500), rng.uniform(1, 2.0 ** 30, 500),
        [2.0 ** 30 - 2.0 ** -20, np.nextafter(2.0 ** 30, 0), 1.0, 0.5,
         1e-9, 0.0],
    ])
    assert reals.max() < 2.0 ** 30
    for real in reals:
        real = float(real)
        try:
            want = ref.quantize_multiplier(real)
        except ValueError:
            with pytest.raises(ValueError):
                requant.quantize_multiplier(real)
            continue
        assert requant.quantize_multiplier(real) == want, real


@pytest.mark.parametrize("real", [2.0 ** 30, 2.0 ** 31, -1.0,
                                  float("inf"), float("nan")])
def test_quantize_multiplier_raises_where_reference_does(real):
    with pytest.raises(ValueError):
        ref.quantize_multiplier(real)
    with pytest.raises(ValueError):
        requant.quantize_multiplier(real)


def test_quantize_and_dequantize_bitwise_equal_reference():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((64, 33)) * 3).astype(np.float32)
    x[0, :4] = [0.5, -0.5, 1.5, -2.5]     # exact ties at scale 1
    for scale in (1.0, 0.0123456789, 3.3e-3, 0.1):
        want = np.asarray(ref_quantize(x, RefQParams(scale=scale)))
        got = qtensor.quantize(torch.from_numpy(x),
                               qtensor.QParams(scale=scale))
        np.testing.assert_array_equal(got.numpy(), want)
        want_f = np.asarray(ref_dequantize(want, RefQParams(scale=scale)))
        got_f = qtensor.dequantize(got, qtensor.QParams(scale=scale))
        np.testing.assert_array_equal(got_f.numpy(), want_f)
    per_ch = rng.uniform(1e-3, 1e-1, 33)
    want = np.asarray(ref_quantize(x, RefQParams(scale=per_ch, axis=1)))
    got = qtensor.quantize(torch.from_numpy(x),
                           qtensor.QParams(scale=per_ch, axis=1))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# The Q12 GRU update.
# ---------------------------------------------------------------------------

D_H = 256      # one row holds every Q7 hidden value, -128 .. 127


def _gates(rng, rows: int) -> np.ndarray:
    """``[rows, 3 * D_H]`` int32 gate pre-activations: the int32 limits,
    the ``±2**18`` clip and the hard gates' corners, and draws over the
    full int32 range and over the gates' linear regions."""
    edges = np.array([I32_MIN, I32_MIN + 1, I32_MAX, I32_MAX - 1, 0, 1, -1,
                      -2, 2, 3, -3, 4096, -4096, 8192, -8192, 8190, -8194,
                      (1 << 18) - 1, 1 << 18, (1 << 18) + 1, -(1 << 18) - 1,
                      -(1 << 18), -(1 << 18) + 1], np.int64)
    g = 3 * D_H
    out = np.concatenate([
        rng.choice(edges, (rows // 4, g)),
        rng.integers(I32_MIN, I32_MAX, (rows // 4, g), endpoint=True),
        rng.integers(-(1 << 19), 1 << 19, (rows // 4, g)),
        rng.integers(-(1 << 14), 1 << 14, (rows - 3 * (rows // 4), g)),
    ])
    return out.astype(np.int32)


def test_gru_update_q12_bitwise_equals_reference():
    rng = np.random.default_rng(3)
    rows = 64
    gx, gh = _gates(rng, rows), _gates(rng, rows)
    gh = gh[rng.permutation(rows)]
    h = np.tile(np.arange(-128, 128, dtype=np.int8), (rows, 1))
    want = np.asarray(ref.gru_update_q12(gx, gh, h, D_H))
    got = requant.gru_update_q12(torch.from_numpy(gx), torch.from_numpy(gh),
                                 torch.from_numpy(h), D_H)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    # the grid reaches both int8 limits and every gate's saturation
    assert {-128, 127} <= set(np.unique(want).tolist())


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(I32_MIN, I32_MAX), min_size=6, max_size=6),
       st.integers(-128, 127))
def test_gru_update_q12_property(gates, h):
    """Any int32 pre-activations and any Q7 state, one channel at a
    time."""
    gx = np.array([gates[:3]], np.int32)
    gh = np.array([gates[3:]], np.int32)
    hq = np.array([[h]], np.int8)
    want = np.asarray(ref.gru_update_q12(gx, gh, hq, 1))
    got = requant.gru_update_q12(torch.from_numpy(gx), torch.from_numpy(gh),
                                 torch.from_numpy(hq), 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrap_i32_is_int32_overflow():
    v = torch.tensor([I32_MAX + 1, I32_MIN - 1, (1 << 32) + 5, -7, 2 ** 40])
    got = requant.wrap_i32(v).tolist()
    assert got == [I32_MIN, I32_MAX, 5, -7, 0]
