"""select_survivors' plain version against the JAX package, and the key
packing its kernel relies on, on the CPU.

- `select_plain`'s three outputs (the survivors, the relocation rows' mask
  and the survivor count) equal the reference's `_accept_select_apply`
  (its `_select`, the `sv_r_ext` it hands `_apply`, its `accepted`) on the
  four small fixtures, greedy and Metropolis, and the reference's
  `_select` on every synthetic case of the card's tests (ties, signed
  zeros, out-of-range partitions, none accepted, K = 16,383, the north
  star's segment count).  All exact.
- `epoch_keys` is the kernel's unsigned key layout, orders a step's
  candidates exactly as the stable argsort of their deltas does, and a key
  of an earlier epoch always loses to every key of a later one (what lets
  the kernel keep its segment minima from step to step without a clear).
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cruise_control_tpu.analyzer import DEFAULT_CHAIN as J_CHAIN
from cruise_control_tpu.analyzer import Engine as JEngine
from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
from cruise_control_tpu.testing import fixtures as jf
from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN as T_CHAIN
from cruise_control_tpu_torch.analyzer import Engine as TEngine
from cruise_control_tpu_torch.analyzer import OptimizerConfig as TConfig
from cruise_control_tpu_torch.analyzer.draws import Key
from cruise_control_tpu_torch.convert import from_jax_arrays
from cruise_control_tpu_torch.kernels import select as select_k
from cruise_control_tpu_torch.kernels.candidates import StepKeys, candidates_plain
from cruise_control_tpu_torch.models.state import STATE_FIELDS
from cruise_control_tpu_torch.testing.fixtures import SELECT_CASES, SELECT_INPUTS, select_case

FAST = dict(num_candidates=256, leadership_candidates=64, steps_per_round=24, num_rounds=3, seed=1)
FIXTURES = ["small_cluster", "rack_violated_cluster", "dead_broker_cluster", "jbod_cluster"]
KEYS = settings(max_examples=200, deadline=None, derandomize=True)
DELTAS = st.lists(st.one_of(st.floats(width=32, allow_nan=False),
                            st.sampled_from([0.0, -0.0, 1.0, -1.0, float("inf"), float("-inf")])),
                  min_size=1, max_size=300)


def _port(js):
    arrays = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    return from_jax_arrays(arrays, "cpu", shape=dataclasses.asdict(js.shape))


@pytest.mark.parametrize("name", FIXTURES)
def test_select_plain_matches_jax_accept_select_apply(name):
    js = getattr(jf, name)()
    je = JEngine(js, J_CHAIN, config=JConfig(**FAST))
    te = TEngine(_port(js), T_CHAIN, config=TConfig(**FAST))
    jsx = je.statics
    jc, tc = je._jit_init(jsx, jax.random.PRNGKey(4)), te.init_carry(Key.from_seed(4))
    jp, tp = je._jit_plan(jsx, jc), te.plan(tc)
    key, k_r, k_s, k_l, k_u = jax.random.split(jc.key, 5)
    jprop = je._assemble_prop(jsx, jc, *je._propose_kinds(jsx, jc, k_r, k_s, k_l,
                                                          je._globals(jsx, jc), jp))
    seen = {}
    select, apply = je._select, je._apply

    def record_select(*a, **kw):
        seen["survive"] = np.asarray(select(*a, **kw))
        return seen["survive"]

    def record_apply(sx, carry, sv_r, *a, **kw):
        seen["sv_r"] = np.asarray(sv_r)
        return apply(sx, carry, sv_r, *a, **kw)

    je._select, je._apply = record_select, record_apply
    accepted = 0
    for temperature in (0.0, 1e-3):
        _, jstats = je._accept_select_apply(jsx, jc, jprop, jnp.float32(temperature), key, k_u)
        tprop = candidates_plain(te.cand, te.statics, tc, StepKeys.of(tc.key), te._globals(tc), tp,
                                 temperature)
        acc = torch.full((1,), 7, dtype=torch.int64)
        survive, sv_r, acc_out = select_k.select_plain(
            *(tprop[f] for f in SELECT_INPUTS), te.shape.B, te.shape.P, tprop["nr"], tprop["ns"],
            acc,
        )
        np.testing.assert_array_equal(survive.numpy(), seen["survive"])
        np.testing.assert_array_equal(sv_r.numpy(), seen["sv_r"])
        assert acc_out is acc and int(acc) - 7 == int(jstats["accepted"])
        accepted += int(jstats["accepted"])
    assert accepted > 0


@pytest.mark.parametrize("case", SELECT_CASES)
def test_select_plain_matches_jax_select(case):
    c = select_case(case)
    B, P, n_r, n_s = c["B"], c["P"], c["n_r"], c["n_s"]
    ref = np.asarray(JEngine._select(SimpleNamespace(shape=SimpleNamespace(B=B, P=P)),
                                     *(jnp.asarray(c[f]) for f in SELECT_INPUTS)))
    survive, sv_r, acc = select_k.select_plain(*(torch.from_numpy(c[f]) for f in SELECT_INPUTS),
                                               B, P, n_r, n_s)
    np.testing.assert_array_equal(survive.numpy(), ref)
    sv_s = ref[n_r:n_r + n_s]
    np.testing.assert_array_equal(sv_r.numpy(), np.concatenate([ref[:n_r], sv_s, sv_s]))
    assert acc.tolist() == [int(ref.sum())]
    assert ref.any() == (case != "none_accepted")


def _unsigned_key(d: float, k: int, epoch: int, K: int) -> int:
    """The kernel's key (csrc/select.cu), in Python integers."""
    ib = select_k.index_bits(K)
    b = int(np.float32(0.0 if d == 0 else d).view(np.uint32))
    ordered = (~b & 0xFFFFFFFF) if b & 0x80000000 else b | 0x80000000
    return ((1 << (32 - ib)) - 1 - epoch) << (32 + ib) | ordered << ib | k


@KEYS
@given(deltas=DELTAS, data=st.data())
def test_epoch_keys_are_the_kernels_keys(deltas, data):
    d = np.array(deltas, np.float32)
    K = d.size
    epoch = data.draw(st.integers(1, select_k.max_epoch(K)))
    keys = select_k.epoch_keys(torch.from_numpy(d), epoch).tolist()
    assert keys == [_unsigned_key(float(x), k, epoch, K) - (1 << 63) for k, x in enumerate(d)]


@KEYS
@given(deltas=DELTAS, data=st.data())
def test_epoch_keys_order_as_stable_argsort(deltas, data):
    d = np.array(deltas, np.float32)
    epoch = data.draw(st.integers(1, select_k.max_epoch(d.size)))
    keys = select_k.epoch_keys(torch.from_numpy(d), epoch).numpy()
    np.testing.assert_array_equal(np.argsort(keys, kind="stable"), np.argsort(d, kind="stable"))
    assert np.unique(keys).size == keys.size
    assert (keys < np.iinfo(np.int64).max).all()  # below the cleared value


@KEYS
@given(fresh=DELTAS, data=st.data())
def test_stale_epoch_keys_always_lose(fresh, data):
    d = np.array(fresh, np.float32)
    K = d.size
    stale = np.array(data.draw(st.lists(st.floats(width=32, allow_nan=False), min_size=K,
                                        max_size=K)), np.float32)
    now = data.draw(st.integers(2, select_k.max_epoch(K)))
    before = data.draw(st.integers(1, now - 1))
    new_keys = select_k.epoch_keys(torch.from_numpy(d), now)
    old_keys = select_k.epoch_keys(torch.from_numpy(stale), before)
    assert int(old_keys.min()) > int(new_keys.max())
