"""The port's fused candidate step and deterministic scatter against the JAX
package's engine, on the CPU (the kernels' plain versions).

- The step's keys, derived on the host for the candidates kernel, equal
  `jax.random.split`'s word for word.
- `candidates_plain` gives, per move kind, the reference's candidate ids,
  feasibility and acceptance exactly and its deltas within rtol 1e-6,
  atol 1e-12 (f32 rounding of sums over brokers; the two agree bit for bit
  on these clusters), from the same carry, plan and key.
- `apply_plain` adds every float aggregate in the reference's `_apply`
  order: bit for bit on a survivor set whose additions meet on shared
  hosts and on a swap's two brokers, with values from 1e-2 to 1e8.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import DEFAULT_CHAIN as J_CHAIN
from cruise_control_tpu.analyzer import Engine as JEngine
from cruise_control_tpu.analyzer import OptimizerConfig as JConfig
from cruise_control_tpu.models.state import ClusterShape as JShape
from cruise_control_tpu.models.state import ClusterState as JState
from cruise_control_tpu.testing import fixtures as jf
from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN as T_CHAIN
from cruise_control_tpu_torch.analyzer import Engine as TEngine
from cruise_control_tpu_torch.analyzer import OptimizerConfig as TConfig
from cruise_control_tpu_torch.analyzer.draws import Key
from cruise_control_tpu_torch.analyzer.engine import SamplingPlan
from cruise_control_tpu_torch.convert import from_jax_arrays, to_numpy
from cruise_control_tpu_torch.kernels.apply import apply_plain
from cruise_control_tpu_torch.kernels.candidates import StepKeys, candidates_plain, key_table
from cruise_control_tpu_torch.models.state import STATE_FIELDS
from cruise_control_tpu_torch.testing.fixtures import apply_collision_case, collision_cluster

RTOL, ATOL = 1e-6, 1e-12
FAST = dict(num_candidates=256, leadership_candidates=64, steps_per_round=24, num_rounds=3, seed=1)
FLOATS = ("broker_load", "broker_potential_nw_out", "broker_leader_bytes_in", "disk_load", "host_load")
INTS = ("replica_broker", "replica_disk", "replica_is_leader", "broker_replica_count",
        "broker_leader_count", "broker_topic_count", "part_rack_count")


def _words(k) -> tuple[int, int]:
    return tuple(int(x) for x in np.asarray(k))


@pytest.mark.parametrize("seed", [0, 4, 2**40 + 3])
def test_step_keys_match_jax_split(seed):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    keys = StepKeys.of(Key(*_words(jkey)))
    # the row the kernel reads: the run's key table, whose first row is
    # this carry key's step
    row = key_table(Key(*_words(jkey)), 2)[0]
    assert [int(x) for x in row] == keys.words()
    c = StepKeys.from_words(row)
    nxt, k_r, k_s, k_l, k_u = jax.random.split(jkey, 5)
    r_src, r_dst = jax.random.split(k_r)
    s_src, s_q = jax.random.split(k_s)
    assert keys.next.words == _words(nxt)
    for got, want in (
        (list(c.rel_src), jax.random.split(r_src, 4)), (list(c.swap_src), jax.random.split(s_src, 4)),
        ([c.rel_dst, c.swap_q, c.lead, c.u], [r_dst, s_q, k_l, k_u]),
    ):
        assert [(k.k0, k.k1) for k in got] == [_words(w) for w in want]


def _port(js):
    arrays = {f: np.asarray(getattr(js, f)) for f in STATE_FIELDS}
    return from_jax_arrays(arrays, "cpu", shape=dataclasses.asdict(js.shape))


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, its carry and plan, port engine, its carry) per fixture."""
    out = {}
    for name in ("small_cluster", "dead_broker_cluster", "rack_violated_cluster"):
        js = getattr(jf, name)()
        je = JEngine(js, J_CHAIN, config=JConfig(**FAST))
        te = TEngine(_port(js), T_CHAIN, config=TConfig(**FAST))
        jc = je._jit_init(je.statics, jax.random.PRNGKey(4))
        out[name] = (je, jc, je._jit_plan(je.statics, jc), te, te.init_carry(Key.from_seed(4)))
    return out


@pytest.mark.parametrize("temperature", [0.0, 1e-3])
@pytest.mark.parametrize("with_plan", [False, True])
@pytest.mark.parametrize("name", ["small_cluster", "dead_broker_cluster", "rack_violated_cluster"])
def test_candidates_plain_matches_reference(engines, name, with_plan, temperature):
    je, jc, jp, te, tc = engines[name]
    jsx = je.statics
    # the same plan on both sides (the port's own plan is held in
    # tests/test_torch_engine.py)
    jplan = jp if with_plan else None
    tplan = SamplingPlan(**{f.name: torch.from_numpy(np.asarray(getattr(jp, f.name)).copy())
                            for f in dataclasses.fields(SamplingPlan)}) if with_plan else None
    key, k_r, k_s, k_l, k_u = jax.random.split(jc.key, 5)
    raw = je._propose_kinds(jsx, jc, k_r, k_s, k_l, je._globals(jsx, jc), jplan)
    prop = candidates_plain(te.cand, te.statics, tc, StepKeys.of(tc.key), te._globals(tc), tplan,
                            temperature)
    K_r, K_s, K_l = te.K_r, te.K_s, te.K_l
    assert (K_r, K_s, K_l) == (je.K_r, je.K_s, je.K_l)
    kinds = {
        "relocation": (slice(0, K_r), raw[0], (4, 4)),
        "swap": (slice(K_r, K_r + K_s), raw[1], (4, 5)),
        "leadership": (slice(K_r + K_s, K_r + K_s + K_l), raw[2], (4, 4)),
    }
    for kind, (sl, bundle, (p1, p2)) in kinds.items():
        delta, feas, src, dst = bundle[:4]
        for got, want, what in ((prop["feas"], feas, "feas"), (prop["src"], src, "src"),
                                (prop["dst"], dst, "dst"), (prop["part1"], bundle[p1], "part1"),
                                (prop["part2"], bundle[p2], "part2")):
            np.testing.assert_array_equal(got[sl].numpy(), np.asarray(want), err_msg=f"{kind} {what}")
        np.testing.assert_allclose(prop["delta"][sl].numpy(), np.asarray(delta), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{kind} delta")
    # the payload rows the scatter reads, and the Metropolis acceptance
    jprop = je._assemble_prop(jsx, jc, *raw)
    for f in ("r", "src", "dst", "d_src", "d_dst", "is_lead", "topic", "part"):
        np.testing.assert_array_equal(prop["payr"][f].numpy(), np.asarray(jprop["payr"][f]), err_msg=f)
    for f in ("load", "pot", "lbin"):
        np.testing.assert_allclose(prop["payr"][f].numpy(), np.asarray(jprop["payr"][f]), rtol=0, atol=0,
                                   err_msg=f)
    for f in ("rf", "rt", "src_b", "dst_b", "d_f", "d_t"):
        np.testing.assert_array_equal(prop["payl"][f].numpy(), np.asarray(jprop["payl"][f]), err_msg=f)
    for f in ("dl_f", "dl_t", "dlbin_src", "dlbin_dst"):
        np.testing.assert_allclose(prop["payl"][f].numpy(), np.asarray(jprop["payl"][f]), rtol=0, atol=0,
                                   err_msg=f)
    u = jax.random.uniform(k_u, (K_r + K_s + K_l,), minval=1e-12, maxval=1.0)
    thresh = -jnp.float32(temperature) * jnp.log(u)
    accept = np.asarray(jprop["feas"] & (jprop["delta"] < thresh - 1e-12))
    np.testing.assert_array_equal(prop["accept"].numpy(), accept)
    assert accept.any()


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_plain_bitwise_reference(seed):
    ts = collision_cluster("cpu")
    arrays = to_numpy(ts)
    js = JState(shape=JShape(**dataclasses.asdict(ts.shape)),
                **{f: jnp.asarray(a) for f, a in arrays.items()})
    sv_r, payr, sv_l, payl, agg = apply_collision_case(ts, seed)
    je = JEngine(js, J_CHAIN, config=JConfig(**FAST))
    te = TEngine(ts, T_CHAIN, config=TConfig(**FAST))
    jc = dataclasses.replace(je._jit_init(je.statics, jax.random.PRNGKey(0)),
                             **{f: jnp.asarray(a) for f, a in agg.items()})
    tc = te.init_carry(Key.from_seed(0))
    for f, a in agg.items():
        setattr(tc, f, torch.from_numpy(a.copy()))
    jc2 = je._apply(je.statics, jc, jnp.asarray(sv_r), {k: jnp.asarray(v) for k, v in payr.items()},
                    jnp.asarray(sv_l), {k: jnp.asarray(v) for k, v in payl.items()})
    apply_plain(te.statics, tc, torch.from_numpy(sv_r), {k: torch.from_numpy(v) for k, v in payr.items()},
                torch.from_numpy(sv_l), {k: torch.from_numpy(v) for k, v in payl.items()})
    for f in INTS:
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc2, f)), err_msg=f)
    changed = 0
    for f in FLOATS:
        got, want = getattr(tc, f).numpy(), np.asarray(getattr(jc2, f))
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=f)
        changed += int((got != agg[f]).sum())
    assert changed > 0


def test_cpu_step_launches_no_kernel():
    ts = _port(jf.small_cluster())
    te = TEngine(ts, T_CHAIN, config=TConfig(**FAST))
    carry = te.init_carry(Key.from_seed(0))
    kernels.reset_launches()
    carry, stats = te.step(carry, 0.0, te.plan(carry))
    assert int(stats["accepted"]) > 0
    assert set(kernels.LAUNCHES) == {"threefry_uniform", "move_delta", "candidates",
                                     "select_survivors", "apply_moves", "group_by_broker",
                                     "refresh_aggregates", "step_globals", "round_schedule",
                                     "scatter_loads", "scenario_step", "candidates_shard",
                                     "shard_sources", "own_rows", "own_member_rows", "own_parts",
                                     "shard_prc"}
    assert all(v == 0 for v in kernels.LAUNCHES.values())
