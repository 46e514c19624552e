"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  On a machine
with a card (and no JAX) run them with
`python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py`.
Bars: threefry draws bit-exact; select_survivors' survivors, relocation
mask and survivor count exact (fresh, over successive epochs of one buffer
and replayed from a captured graph); step_globals within rtol 1e-6 and the
same bits call after call; apply_moves bit for bit (it adds in the
reference's order), with every slot back at -1 after a call, on a real
step, hand-built survivor sets (none, all on one shared host, brokers with
no host, one broker a host, ids out of range) and a captured graph's
replays; round_schedule's phases exact against the plain version, EXIT
included; the loop graph's ys bytes, final carry and counted launches
equal to the same schedule run round by round on the card; move_delta within 1e-4 relative
plus 1e-6 of the batch's largest delta (the kernel divides where PyTorch's
CUDA ops multiply by reciprocals of scalars, and each delta is a
difference of lane sums); the candidates kernel's ids, masks and payload
rows exact, its deltas within move_delta's bar, and its acceptance
identical except where the plain delta lies within that bar of the
Metropolis threshold, also with the intra-broker disk terms in every delta
and with the intra-broker kind (rebalance_disk: no swap or leadership
rows) on the JBOD fixtures; apply_moves bit for bit on the intra kind's
survivors, whose src and dst are one broker; the graph route against the
legacy route at T=0 in the intra-broker mode and with a warm start.  The
prior and bf16 variants of candidates against their plain versions under
the same bars, the took-the-prior mask exact (a cold prior's bundle the
prior-off one); select_survivors' diagnostics instantiation: survivors and
its six counts exact; the schedule's diagnostics columns exact, EXIT
included; each mode's fused run with one graph launch and one sync
(diagnostics: the placements of the run without them; the prior:
rebind_prior with no capture).  scatter_loads bit for bit against its
plain version (no row, one, a subset, every row, sentinel, negative and
out-of-range rows); a steady-state streaming cycle that captures nothing,
launches the loop graph and the two report graphs once each, makes one
sync and equals the staged path bit for bit.  scenario_step exact against
its plain version; the scenario batch graph: one graph launch and one sync
a batch, each scenario's objective and violations bit for bit those of
scoring it alone, no capture on a second batch; score_state's graph bit
for bit the eager chain and stats.  round_schedule driven launch by launch
to slice ends (segmented execution) exact against the plain version, its
ys those of the whole run; a segmented run bit for bit the one-launch run
in every candidates variant and with diagnostics (placements, records, ys
bytes, carry; one slice-graph launch and one sync a slice, no capture, the
launches plus one EXIT a slice), and a segmented reported run's payload
bit for bit the one-launch run's.  Supervision: the watchdog's probe
answers on a stream of its own while the current stream spins; the
allocator's real out-of-memory error classifies as OOM, through the
supervisor too, with no retry; a capture that fails leaves no graph
behind, releases the capture lock, and the next run captures anew; a
supervised optimize with an injected OOM raises `DeviceDegradedError`
(no answer from the CPU), and after the probe the unsupervised run bit
for bit; a call abandoned at its deadline while the card spins holds the
breaker open until its worker returns.  The sharded-model mode's gathers
byte for byte their plain versions on every shard for n = 1, 2 and 4:
hop 4's one launch (also without leadership rows or without relocation
and swap rows), ids at and past a shard's first and last rows, and
`shard_sources` with the CDF in shared memory and in global memory and
with importance draws of brokers that hold no replica.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from cruise_control_tpu_torch import kernels
from cruise_control_tpu_torch.analyzer import DEFAULT_CHAIN, Engine, OptimizerConfig
from cruise_control_tpu_torch.analyzer.draws import Key
from cruise_control_tpu_torch.analyzer.goals import DEFAULT_INTRA_BROKER_GOAL_ORDER
from cruise_control_tpu_torch.analyzer.objective import GoalChain
from cruise_control_tpu_torch.kernels import apply as apply_k
from cruise_control_tpu_torch.kernels import candidates as cand_k
from cruise_control_tpu_torch.kernels import move_delta as md
from cruise_control_tpu_torch.kernels import select as select_k
from cruise_control_tpu_torch.kernels import threefry
from cruise_control_tpu_torch.testing import fixtures
from cruise_control_tpu_torch.testing.fixtures import (
    SELECT_CASES,
    SELECT_INPUTS,
    RandomClusterSpec,
    apply_collision_case,
    collision_cluster,
    random_cluster,
    select_case,
)

pytestmark = pytest.mark.cuda
CFG = OptimizerConfig(num_candidates=512, leadership_candidates=128, steps_per_round=8, num_rounds=2, seed=3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 1000, 65537])
def test_threefry_bit_exact(cuda, n):
    for seed in (0, 1, 7):
        key = Key.from_seed(seed).split(3)[1].words
        before = kernels.LAUNCHES["threefry_uniform"]
        got = threefry.uniform(key, n, minval=1e-12, maxval=1.0, device=cuda)
        assert kernels.LAUNCHES["threefry_uniform"] == before + 1
        ref = threefry.uniform_plain(key, n, 1e-12, 1.0, cuda)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
        for bound in (1, 777, 500_001):
            assert torch.equal(threefry.uniform_idx(key, n, bound, device=cuda),
                               threefry.uniform_idx_plain(key, n, bound, cuda))


def _select_args(case: dict, device) -> list:
    return [torch.from_numpy(case[f]).to(device) for f in SELECT_INPUTS]


def _same_select(got, want, acc_before: int) -> None:
    """The kernel's (survive, sv_r, acc) against the plain version's; the
    kernel added its count to an accumulator that held acc_before."""
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert int(got[2]) - acc_before == int(want[2])


@pytest.mark.parametrize("case", SELECT_CASES)
def test_select_exact(cuda, case):
    """Survivors, the relocation rows' mask and the survivor count exactly
    the plain version's: in fresh buffers, and in one buffer over
    successive epochs with new inputs each (a minimum left by an earlier
    step must lose), up to the last epoch the keys can tag."""
    c = select_case(case)
    K, B, P, n_r, n_s = (c[k] for k in ("K", "B", "P", "n_r", "n_s"))
    args = _select_args(c, cuda)
    before = kernels.LAUNCHES["select_survivors"]
    got = select_k.select_survivors(*args, num_brokers=B, num_parts=P, n_r=n_r, n_s=n_s)
    assert kernels.LAUNCHES["select_survivors"] == before + 1
    want = select_k.select_plain(*args, B, P, n_r, n_s)
    _same_select(got, want, 0)
    assert bool(got[0].any()) == (case != "none_accepted")
    top = select_k.max_epoch(K)
    bufs = select_k.select_buffers(K, n_r, n_s, B, P, cuda, n_epochs=top)
    acc = torch.full((1,), 5, dtype=torch.int64, device=cuda)
    for seed, epoch in ((1, 1), (2, 2), (0, 3), (3, top - 1), (1, top)):
        args = _select_args(select_case(case, seed), cuda)
        before = int(acc)
        got = select_k.select_survivors(*args, num_brokers=B, num_parts=P, n_r=n_r, n_s=n_s, acc=acc,
                                        bufs=bufs, epoch=select_k.Epoch(epoch - 1))
        assert got[2] is acc
        _same_select(got, select_k.select_plain(*args, B, P, n_r, n_s), before)


def test_select_replays_in_a_captured_graph(cuda):
    """The cluster launch captured into a CUDA graph (the round body's
    way): replays at growing epochs, the round index read on the device,
    give the plain version's outputs on new inputs each replay."""
    c = select_case("k16384")
    K, B, P, n_r, n_s = (c[k] for k in ("K", "B", "P", "n_r", "n_s"))
    args = _select_args(c, cuda)
    rnd = torch.zeros(1, dtype=torch.int32, device=cuda)
    bufs = select_k.select_buffers(K, n_r, n_s, B, P, cuda, n_epochs=8)
    acc = torch.zeros(1, dtype=torch.int64, device=cuda)

    def step():
        return select_k.select_survivors(*args, num_brokers=B, num_parts=P, n_r=n_r, n_s=n_s,
                                         acc=acc, bufs=bufs, epoch=select_k.Epoch(1, rnd, 2))

    step()  # loads the kernel outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    bufs.clear()
    for r in range(4):
        for t, a in zip(args, _select_args(select_case("k16384", r), cuda)):
            t.copy_(a)
        rnd.fill_(r)
        before = int(acc)
        graph.replay()
        _same_select(out, select_k.select_plain(*args, B, P, n_r, n_s), before)


def _step_inputs(cuda, temperature=0.0, with_plan=True):
    """One anneal step of a small cluster on the card: the engine, carry,
    globals, the plain candidate bundle, the step's keys and its plan."""
    state = random_cluster(RandomClusterSpec(num_brokers=20, num_partitions=400, skew=1.0), seed=2, device=cuda)
    eng = Engine(state, DEFAULT_CHAIN, config=CFG)
    carry = eng.init_carry(Key.from_seed(5))
    plan = eng.plan(carry) if with_plan else None
    g = eng._globals(carry)
    keys = cand_k.StepKeys.of(carry.key)
    prop = cand_k.candidates_plain(eng.cand, eng.statics, carry, keys, g, plan, temperature)
    return eng, carry, g, prop, keys, plan


def _move_delta_calls(device):
    """The keyword arguments of the three move_delta evaluations
    (relocations, swaps, leadership transfers) of one anneal step of a
    small cluster."""
    calls = []
    wrapped = md.move_delta_plain

    def record(*args, **kw):
        calls.append(dict(kw))
        return wrapped(*args, **kw)

    md.move_delta_plain = record
    try:
        eng, carry, g, _, _, _ = _step_inputs(device)
    finally:
        md.move_delta_plain = wrapped
    assert [int(kw["src"].shape[0]) for kw in calls] == [eng.K_r, eng.K_s, eng.K_l]
    return eng, carry, g, dict(zip(("relocation", "swap", "leadership"), calls))


def _distinct_src_lane(kw: dict, g: dict) -> dict:
    """Leadership inputs whose src-side leader bytes differ from the dst
    side's.  Both replicas of a partition carry its leader load, so real
    leadership calls have dlbin_src == dlbin; shifting the src side by 1-2x
    the mean leader bytes-in pushes src brokers out of the balance band, so
    a kernel that mixes up or ignores the lanes shows."""
    u = torch.linspace(1.0, 2.0, kw["dlbin"].shape[0], device=kw["dlbin"].device)
    return dict(kw, dlbin_src=kw["dlbin"] + g["avg_lbin"] * u)


@pytest.mark.parametrize("kind", ["relocation", "swap", "leadership", "leadership_distinct_src"])
def test_move_delta_matches_plain(cuda, kind):
    eng, carry, g, calls = _move_delta_calls(cuda)
    kw = calls[kind.removesuffix("_distinct_src")]
    if kind == "leadership_distinct_src":
        kw = _distinct_src_lane(kw, g)
    got = md.move_delta(eng.tp, eng.statics, carry, g, **kw)
    ref = md.move_delta_plain(eng.tp, eng.statics, carry, g, **kw)
    scale = float(ref.abs().max())
    assert scale > 0.0
    assert torch.all((got - ref).abs() <= 1e-4 * ref.abs() + 1e-6 * scale + 1e-12)


def test_apply_matches_plain(cuda):
    eng, carry, _, prop, _, _ = _step_inputs(cuda)
    nr, ns = prop["nr"], prop["ns"]
    survive, sv_r, _ = select_k.select_survivors(
        prop["feas"], prop["delta"], prop["src"], prop["dst"], prop["part1"], prop["part2"],
        num_brokers=eng.shape.B, num_parts=eng.shape.P, n_r=nr, n_s=ns,
    )
    sv_l = survive[nr + ns:]
    ck, cp = carry.clone(), carry.clone()
    apply_k.apply_moves(eng.statics, ck, sv_r, prop["payr"], sv_l, prop["payl"])
    # one broker per host here, so no index repeats inside one index_add_
    # and the plain version's CUDA atomics add in the reference's order too
    apply_k.apply_plain(eng.statics, cp, sv_r, prop["payr"], sv_l, prop["payl"])
    for f in ("replica_broker", "replica_disk", "replica_is_leader", "broker_replica_count",
              "broker_leader_count", "broker_topic_count", "part_rack_count", "broker_load",
              "broker_potential_nw_out", "broker_leader_bytes_in", "disk_load", "host_load"):
        assert torch.equal(getattr(ck, f), getattr(cp, f)), f
    assert int(survive.sum()) > 0
    assert torch.equal(eng.statics.apply_slots, torch.full_like(eng.statics.apply_slots, -1))


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_bitwise_on_collisions(cuda, seed):
    """Survivors meeting on shared hosts and a swap's two brokers: the
    kernel's floats equal the plain version's on the CPU (which adds in
    index order, the reference's) bit for bit, run after run."""
    state = collision_cluster(cuda)
    eng = Engine(state, DEFAULT_CHAIN, config=CFG)
    sv_r, payr, sv_l, payl, agg = apply_collision_case(state, seed)
    carry = eng.init_carry(Key.from_seed(0))
    for f, a in agg.items():
        setattr(carry, f, torch.from_numpy(a.copy()).to(cuda))
    want = carry.clone()
    for f in _tensor_fields(want):
        setattr(want, f, getattr(want, f).cpu())
    sx_cpu = Engine(collision_cluster("cpu"), DEFAULT_CHAIN, config=CFG).statics
    apply_k.apply_plain(sx_cpu, want, *_case(sv_r, payr, sv_l, payl, "cpu"))
    for _ in range(3):
        got = carry.clone()
        apply_k.apply_moves(eng.statics, got, *_case(sv_r, payr, sv_l, payl, cuda))
        for f in _tensor_fields(want):
            a, b = getattr(got, f).cpu(), getattr(want, f)
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), f


def _apply_rows(state, survivors: list, seed: int, n_rel: int = 12, n_lead: int = 6,
                bad_rows: bool = False):
    """A survivor set for apply_moves on `state`, numpy arrays as
    `apply_collision_case` gives them: the (src, dst) pairs `survivors`
    (the first n_rel // 2 relocation rows, the rest leadership rows) at
    random positions among rows that do not survive, distinct replicas,
    and loads and float aggregates from 1e-2 to 1e8.  With `bad_rows`,
    surviving rows whose ids lie out of range: a src or a dst broker, a
    replica, topic, partition or disk.  Each broker must be the src of at
    most one pair and the dst of at most one, as select_survivors
    guarantees."""
    rng = np.random.default_rng(seed)
    s = state.shape
    B, D, H, R, T, P = s.B, s.max_disks_per_broker, s.num_hosts, s.R, s.num_topics, s.P

    def mixed(*shape):
        return (10.0 ** rng.uniform(-2.0, 8.0, shape)).astype(np.float32)

    i32 = np.int32
    payr = dict(r=rng.integers(0, R, n_rel, dtype=i32), src=rng.integers(0, B, n_rel, dtype=i32),
                dst=rng.integers(0, B, n_rel, dtype=i32), d_src=rng.integers(0, D, n_rel, dtype=i32),
                d_dst=rng.integers(0, D, n_rel, dtype=i32), load=mixed(n_rel, 4),
                is_lead=rng.random(n_rel) < 0.5, pot=mixed(n_rel), lbin=mixed(n_rel),
                topic=rng.integers(0, T, n_rel, dtype=i32), part=rng.integers(0, P, n_rel, dtype=i32))
    payl = dict(rf=rng.integers(0, R, n_lead, dtype=i32), rt=rng.integers(0, R, n_lead, dtype=i32),
                src_b=rng.integers(0, B, n_lead, dtype=i32), dst_b=rng.integers(0, B, n_lead, dtype=i32),
                dl_f=-mixed(n_lead, 4), dl_t=mixed(n_lead, 4), dlbin_src=mixed(n_lead),
                dlbin_dst=mixed(n_lead), d_f=rng.integers(0, D, n_lead, dtype=i32),
                d_t=rng.integers(0, D, n_lead, dtype=i32))
    sv_r, sv_l = np.zeros(n_rel, bool), np.zeros(n_lead, bool)
    k_r = min(len(survivors) // 2 + len(survivors) % 2, n_rel // 2)
    rel_rows = np.sort(rng.choice(n_rel, k_r, replace=False))
    lead_rows = np.sort(rng.choice(n_lead, len(survivors) - k_r, replace=False))
    for row, (a, b) in zip(rel_rows, survivors[:k_r]):
        payr["src"][row], payr["dst"][row], sv_r[row] = a, b, True
    for row, (a, b) in zip(lead_rows, survivors[k_r:]):
        payl["src_b"][row], payl["dst_b"][row], sv_l[row] = a, b, True
    bad_r = bad_l = []
    if bad_rows:
        bad_r = [x for x in range(n_rel) if not sv_r[x]][:3]
        bad_l = [x for x in range(n_lead) if not sv_l[x]][:2]
        sv_r[bad_r], sv_l[bad_l] = True, True
        # a src out of range, a dst out of range, and in-range brokers no
        # survivor uses with every other id out of range
        payr["src"][bad_r[0]], payr["dst"][bad_r[1]] = B, -1
        used = {x for pair in survivors for x in pair}
        spare = [x for x in range(B) if x not in used][:2]
        payr["src"][bad_r[2]], payr["dst"][bad_r[2]] = spare
        payr["topic"][bad_r[2]], payr["part"][bad_r[2]] = T, P
        payr["d_src"][bad_r[2]], payr["d_dst"][bad_r[2]] = D, -1
        payl["src_b"][bad_l[0]], payl["dst_b"][bad_l[0]] = spare[1], spare[0]
        payl["d_f"][bad_l[0]], payl["d_t"][bad_l[0]] = -1, D
        payl["src_b"][bad_l[1]] = B + 3
    # survivors move distinct replicas (they touch distinct partitions)
    reps = iter(rng.permutation(R).astype(i32))
    for row in np.nonzero(sv_r)[0]:
        payr["r"][row] = next(reps)
    for row in np.nonzero(sv_l)[0]:
        payl["rf"][row], payl["rt"][row] = next(reps), next(reps)
    if bad_rows:
        payr["r"][bad_r[2]] = R
        payl["rf"][bad_l[0]], payl["rt"][bad_l[0]] = -1, R
    aggregates = dict(
        broker_load=mixed(B, 4), broker_potential_nw_out=mixed(B), broker_leader_bytes_in=mixed(B),
        disk_load=mixed(B, D), host_load=mixed(H, 4),
    )
    return sv_r, payr, sv_l, payl, aggregates


def _cycle(brokers) -> list:
    """(src, dst) pairs moving each broker's row to the next broker."""
    return [(int(a), int(b)) for a, b in zip(brokers, np.roll(brokers, -1))]


def _apply_state(kind: str, device):
    if kind == "host_per_broker":
        return random_cluster(RandomClusterSpec(num_brokers=20, num_partitions=400, skew=1.0),
                              seed=2, device=device)
    state = collision_cluster(device)
    if kind == "no_host":
        # brokers 3 and 5 have no host in range, as padding brokers may (the
        # statics' sentinel group; a valid broker always has a host)
        host, valid = state.broker_host.clone(), state.broker_valid.clone()
        host[[3, 5]] = state.shape.num_hosts
        valid[[3, 5]] = False
        state = dataclasses.replace(state, broker_host=host, broker_valid=valid)
    return state


#: apply_moves' cases: the state and the survivors' (src, dst) pairs
APPLY_CASES = {
    "zero_survivors": ("collision", []),
    # brokers 0, 1, 2 and 8 share host h0
    "one_host": ("collision", _cycle([0, 1, 2, 8])),
    "no_host": ("no_host", _cycle([3, 0, 5]) + _cycle([4, 9])),
    "host_per_broker": ("host_per_broker", _cycle([3, 17, 5, 0, 11, 8, 2])),
    "out_of_range": ("collision", _cycle([0, 6, 1, 7])),
}


def _apply_on_both(state_kind: str, cuda, case, graph_cases=()):
    """apply_moves on the card (once, or captured in a CUDA graph and
    replayed on each of `graph_cases` in turn) and apply_plain on the CPU
    from the same carry: every carry field bit for bit, the slots back at
    -1 and one launch a call."""
    sx = Engine(_apply_state(state_kind, cuda), DEFAULT_CHAIN, config=CFG).statics
    sx_cpu = Engine(_apply_state(state_kind, "cpu"), DEFAULT_CHAIN, config=CFG).statics
    sv_r, payr, sv_l, payl, agg = case
    carry = Engine(sx.state, DEFAULT_CHAIN, config=CFG).init_carry(Key.from_seed(0))
    for f, a in agg.items():
        setattr(carry, f, torch.from_numpy(a.copy()).to(cuda))
    want = carry.clone()
    for f in _tensor_fields(want):
        setattr(want, f, getattr(want, f).cpu())
    inputs = _case(sv_r, payr, sv_l, payl, cuda)
    before = kernels.LAUNCHES["apply_moves"]
    if not graph_cases:
        apply_k.apply_plain(sx_cpu, want, *_case(sv_r, payr, sv_l, payl, "cpu"))
        apply_k.apply_moves(sx, carry, *inputs)
        assert kernels.LAUNCHES["apply_moves"] == before + 1
    else:
        apply_k.apply_moves(sx, carry.clone(), *inputs)  # loads the kernel outside the capture
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            apply_k.apply_moves(sx, carry, *inputs)
        for c in graph_cases:
            sv_r, payr, sv_l, payl, _ = c
            for t, a in zip(_flat(inputs), _flat(_case(sv_r, payr, sv_l, payl, cuda))):
                t.copy_(a)
            graph.replay()
            apply_k.apply_plain(sx_cpu, want, *_case(sv_r, payr, sv_l, payl, "cpu"))
    torch.cuda.synchronize()
    for f in _tensor_fields(want):
        a, b = getattr(carry, f).cpu(), getattr(want, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f
    assert torch.equal(sx.apply_slots, torch.full_like(sx.apply_slots, -1))


def _flat(case) -> list:
    sv_r, payr, sv_l, payl = case
    return [sv_r, *payr.values(), sv_l, *payl.values()]


@pytest.mark.parametrize("name", APPLY_CASES)
def test_apply_cases_bitwise(cuda, name):
    """Zero survivors (nothing changes, every slot back at -1), all
    survivors on one host of four brokers, brokers with no host in range,
    one broker a host (H == B), and surviving rows with ids out of range:
    the card's carry equals the plain version's on the CPU bit for bit."""
    state_kind, pairs = APPLY_CASES[name]
    state = _apply_state(state_kind, "cpu")
    if name == "host_per_broker":
        assert state.shape.num_hosts == state.shape.B
    case = _apply_rows(state, pairs, seed=len(name), bad_rows=name == "out_of_range")
    if name == "zero_survivors":
        assert not case[0].any() and not case[2].any()
    _apply_on_both(state_kind, cuda, case)


def test_apply_replays_in_a_captured_graph(cuda):
    """apply_moves captured in a CUDA graph (the round body's way) and
    replayed over three survivor sets in turn, each moving the carry the
    last left: bit for bit the plain version's sequence on the CPU."""
    state = _apply_state("collision", "cpu")
    cases = [_apply_rows(state, pairs, seed) for seed, pairs in
             enumerate((_cycle([0, 1, 2, 8]), _cycle([3, 4, 9, 7]), _cycle([5, 6, 10, 11, 0])))]
    _apply_on_both("collision", cuda, cases[0], graph_cases=cases)


def _tensor_fields(carry) -> list[str]:
    return [f for f in vars(carry) if isinstance(getattr(carry, f), torch.Tensor)]


def _case(sv_r, payr, sv_l, payl, device):
    def t(a):
        return torch.from_numpy(a).to(device)

    return t(sv_r), {k: t(v) for k, v in payr.items()}, t(sv_l), {k: t(v) for k, v in payl.items()}


def _delta_bar(ref: torch.Tensor) -> torch.Tensor:
    return 1e-4 * ref.abs() + 1e-6 * float(ref.abs().max()) + 1e-12


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("with_plan", [False, True])
def test_candidates_matches_plain(cuda, with_plan, hot):
    eng, carry, g, _, keys, plan = _step_inputs(cuda, with_plan=with_plan)
    _candidates_against_plain(cuda, eng, carry, g, keys, plan, hot)


def _candidates_against_plain(cuda, eng, carry, g, keys, plan, hot: bool, some_accepted=True):
    """The candidates kernel against its plain version on one step: ids,
    masks and payload rows exact, deltas within the bar, acceptance equal
    away from the threshold (and, with `some_accepted`, some candidate
    accepted)."""
    # T > 0: the first round's temperature, init_temperature_scale x objective
    temperature = float(np.float32(float(eng.evaluate(carry)[0]) * 1e-2)) if hot else 0.0
    ref = cand_k.candidates_plain(eng.cand, eng.statics, carry, keys, g, plan, temperature)
    before = kernels.LAUNCHES["candidates"]
    got = cand_k.candidates(eng.cand, eng.statics, carry, keys, g, plan, temperature)
    assert kernels.LAUNCHES["candidates"] == before + 1
    K_r, K_s = eng.K_r, eng.K_s
    kinds = {"relocation": slice(0, K_r), "swap": slice(K_r, K_r + K_s), "leadership": slice(K_r + K_s, None)}
    for kind, sl in kinds.items():
        for f in ("feas", "src", "dst", "part1", "part2"):
            assert torch.equal(got[f][sl], ref[f][sl]), (kind, f)
        d, r = got["delta"][sl], ref["delta"][sl]
        assert bool(torch.isfinite(d).all()), kind
        assert bool(((d - r).abs() <= _delta_bar(ref["delta"])[sl]).all()), kind
    for name in ("payr", "payl"):
        for f, want in ref[name].items():
            assert torch.equal(got[name][f], want), (name, f)
    # acceptance: identical unless the plain delta sits within the delta
    # bar of the threshold, where the two evaluations may fall either side
    u = cand_k.threefry.uniform_plain(keys.u.words, ref["delta"].shape[0], cand_k.U_MIN, 1.0, cuda)
    thresh = -temperature * torch.log(u) - 1e-12
    near = (ref["delta"] - thresh).abs() <= _delta_bar(ref["delta"])
    differ = got["accept"] != ref["accept"]
    print(f"accept differs in {int(differ.sum())} candidates, all within the bar of the threshold")
    assert not bool((differ & ~near).any())
    assert bool(ref["accept"].any()) or not some_accepted
    # the prior variant's took-the-prior mask (None without the prior)
    assert (got["from_prior"] is None) == (ref["from_prior"] is None)
    if ref["from_prior"] is not None:
        assert torch.equal(got["from_prior"], ref["from_prior"])
    return got


CONFIG3_CHAIN = ("RackAwareGoal", "DiskCapacityGoal", "IntraBrokerDiskCapacityGoal",
                 "IntraBrokerDiskUsageDistributionGoal")


def _jbod_step(cuda, fixture: str, intra: bool, with_plan: bool = True, seed: int = 5,
               device=None):
    """One step's inputs on a JBOD fixture: BASELINE configuration 3's
    chain (disk terms in every delta), or the intra-broker mode."""
    state = getattr(fixtures, fixture)(device or cuda)
    chain = GoalChain.from_names(list(DEFAULT_INTRA_BROKER_GOAL_ORDER if intra else CONFIG3_CHAIN))
    eng = Engine(state, chain, config=dataclasses.replace(CFG, intra_broker=intra))
    carry = eng.init_carry(Key.from_seed(seed))
    plan = eng.plan(carry) if with_plan else None
    return eng, carry, eng._globals(carry), cand_k.StepKeys.of(carry.key, intra=intra), plan


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("with_plan", [False, True])
@pytest.mark.parametrize("intra", [False, True], ids=["disk_terms", "intra"])
@pytest.mark.parametrize("fixture", ["jbod_cluster", "collision_cluster"])
def test_candidates_jbod_matches_plain(cuda, fixture, intra, with_plan, hot):
    eng, carry, g, keys, plan = _jbod_step(cuda, fixture, intra, with_plan)
    assert eng.tp.has_disk_terms and eng.shape.max_disks_per_broker == 2
    if intra:
        assert (eng.K_s, eng.K_l) == (0, 0)
    _candidates_against_plain(cuda, eng, carry, g, keys, plan, hot)


@pytest.mark.parametrize("fixture", ["jbod_cluster", "collision_cluster"])
def test_apply_intra_rows_bitwise(cuda, fixture):
    """The intra kind's survivors (src == dst: a broker's load goes out and
    back, two cells of its disk row change) through select_survivors and
    apply_moves on the card, against apply_plain on the CPU bit for bit,
    every slot back at -1; the step has no swap and no leadership rows."""
    eng, carry, g, keys, plan = _jbod_step(cuda, fixture, True)
    prop = cand_k.candidates(eng.cand, eng.statics, carry, keys, g, plan, 0.0)
    nr, ns = prop["nr"], prop["ns"]
    assert ns == 0 and prop["payl"]["rf"].numel() == 0
    survive, sv_r, acc = select_k.select_survivors(
        prop["accept"], prop["delta"], prop["src"], prop["dst"], prop["part1"], prop["part2"],
        num_brokers=eng.shape.B, num_parts=eng.shape.P, n_r=nr, n_s=ns,
    )
    sv_l = survive[nr:]
    assert sv_l.numel() == 0 and int(acc) == int(sv_r.sum()) > 0
    payr = prop["payr"]
    assert torch.equal(payr["src"][sv_r], payr["dst"][sv_r])
    assert bool((payr["d_src"][sv_r] != payr["d_dst"][sv_r]).all())
    sx_cpu = _jbod_step(cuda, fixture, True, device="cpu")[0].statics
    want = carry.clone()
    for f in _tensor_fields(want):
        setattr(want, f, getattr(want, f).cpu())
    cpu = {k: v.cpu() for k, v in payr.items()}
    apply_k.apply_plain(sx_cpu, want, sv_r.cpu(), cpu, sv_l.cpu(), {k: v.cpu() for k, v in prop["payl"].items()})
    before = kernels.LAUNCHES["apply_moves"]
    apply_k.apply_moves(eng.statics, carry, sv_r, payr, sv_l, prop["payl"])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["apply_moves"] == before + 1
    for f in _tensor_fields(want):
        a, b = getattr(carry, f).cpu(), getattr(want, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f
    assert torch.equal(eng.statics.apply_slots, torch.full_like(eng.statics.apply_slots, -1))


@pytest.mark.parametrize("mode", ["intra", "warm_start"])
def test_graph_route_matches_legacy_jbod(cuda, mode):
    """The fused route and the legacy host loop at T=0 in the intra-broker
    mode, and warm-started from another placement with configuration 3's
    chain: identical placements and rounds, one blocking sync; the warm
    start leaves the caller's tensors as they were."""
    intra = mode == "intra"
    state = random_cluster(RandomClusterSpec(num_brokers=20, num_partitions=400, skew=1.0,
                                             disks_per_broker=3), seed=2, device=cuda)
    chain = GoalChain.from_names(list(DEFAULT_INTRA_BROKER_GOAL_ORDER if intra else CONFIG3_CHAIN))
    cfg = dataclasses.replace(CFG, init_temperature_scale=0.0, num_rounds=4, intra_broker=intra)
    start = None
    if not intra:
        first, _ = Engine(state, chain, config=dataclasses.replace(cfg, seed=11)).run()
        start = (first.replica_broker, first.replica_is_leader, first.replica_disk)
        kept = tuple(t.clone() for t in start)
    out = {}
    for fused in (True, False):
        eng = Engine(state, chain, config=dataclasses.replace(cfg, fused_rounds=fused))
        out[fused] = eng.run(initial_placement=start)
    (final_f, hist_f), (final_l, hist_l) = out[True], out[False]
    rounds = [(h["round"], h["accepted"], h.get("early_stop"), h.get("extra")) for h in hist_f if "round" in h]
    assert rounds == [(h["round"], h["accepted"], h.get("early_stop"), h.get("extra"))
                      for h in hist_l if "round" in h]
    assert sum(r[1] for r in rounds) > 0
    for f in ("replica_broker", "replica_is_leader", "replica_disk"):
        assert torch.equal(getattr(final_f, f), getattr(final_l, f)), f
    timing = hist_f[-1]
    assert timing["fused"] is True and timing["blocking_syncs"] == 1 and timing["graph_launches"] == 1
    if intra:
        assert torch.equal(final_f.replica_broker, state.replica_broker)
        assert torch.equal(final_f.replica_is_leader, state.replica_is_leader)
    else:
        for t, k in zip(start, kept):
            assert torch.equal(t, k)


#: the variants of the candidates kernel (its template instantiations)
CAND_VARIANTS = ("default", "prior", "bf16", "disk_terms", "intra")
#: (num_candidates, swap_candidates, leadership_candidates) whose kinds fill
#: their blocks' teams only partly: K_r, K_s, K_l of 81, 7, 13; of 61, 0, 9;
#: and one candidate of each kind
PARTIAL_SPLITS = {"odd": (101, 7, 13), "no_swaps": (70, 0, 9), "one_each": (3, 1, 1)}


def _variant_engine(variant: str, state, **search):
    """(chain, config, prior) of a candidates variant's engine on `state`:
    CFG, or CFG with `search`'s fields."""
    names = {"disk_terms": CONFIG3_CHAIN, "intra": DEFAULT_INTRA_BROKER_GOAL_ORDER}
    chain = GoalChain.from_names(list(names[variant])) if variant in names else DEFAULT_CHAIN
    prior = fixtures.prior_table(state.shape, 1, 0.5) if variant == "prior" else None
    cfg = dataclasses.replace(CFG, prior_enabled=prior is not None, intra_broker=variant == "intra",
                              score_dtype="bfloat16" if variant == "bf16" else "float32", **search)
    return chain, cfg, prior


def _variant_step(cuda, variant: str, fixture: str, split=None, with_plan=True, rf=None):
    """One step's inputs of a candidates variant on a fixture: random_cluster
    (20 brokers, 400 partitions; 2 logdirs a broker for the disk terms and
    the intra kind; every partition of `rf` replicas when given), or a
    JBOD fixture; the candidate split `split` when given."""
    disks = variant in ("disk_terms", "intra")
    if fixture == "random":
        rep = {} if rf is None else dict(min_replication=rf, max_replication=rf, num_brokers=12)
        spec = {**dict(num_brokers=20, num_partitions=400, skew=1.0, disks_per_broker=2 if disks else 1),
                **rep}
        state = random_cluster(RandomClusterSpec(**spec), seed=2 + (rf or 0), device=cuda)
    else:
        state = getattr(fixtures, fixture)(cuda)
    chain, cfg, prior = _variant_engine(variant, state)
    if split is not None:
        n, s, l = split
        cfg = dataclasses.replace(cfg, num_candidates=n, swap_candidates=s, leadership_candidates=l)
    eng = Engine(state, chain, config=cfg, prior=prior)
    carry = eng.init_carry(Key.from_seed(7))
    plan = eng.plan(carry) if with_plan else None
    keys = cand_k.StepKeys.of(carry.key, intra=variant == "intra", prior=prior is not None)
    return eng, carry, eng._globals(carry), keys, plan


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("fixture", ["random", "jbod_cluster", "collision_cluster"])
@pytest.mark.parametrize("variant", CAND_VARIANTS)
def test_candidates_variants_match_plain(cuda, variant, fixture, hot):
    """Each template instantiation of the candidates kernel against its
    plain version on each of the file's three fixtures."""
    eng, carry, g, keys, plan = _variant_step(cuda, variant, fixture)
    assert eng.cand.prior == (variant == "prior") and eng.tp.bf16 == (variant == "bf16")
    assert eng.tp.has_disk_terms == (variant in ("disk_terms", "intra"))
    _candidates_against_plain(cuda, eng, carry, g, keys, plan, hot,
                              some_accepted=fixture == "random")


@pytest.mark.parametrize("with_plan", [False, True], ids=["n_imp_0", "plan"])
@pytest.mark.parametrize("split", PARTIAL_SPLITS)
@pytest.mark.parametrize("variant", ["default", "prior", "intra"])
def test_candidates_partial_teams(cuda, variant, split, with_plan):
    """Kinds whose counts leave a block's teams partly empty (a team past
    its kind's end computes and stores nothing), no swap at all, and no
    importance-sampled source (no plan): against the plain version, and
    nothing written past each kind's rows."""
    counts = PARTIAL_SPLITS[split]
    if variant == "intra":
        counts = (sum(counts) - 2, 0, 0)
    eng, carry, g, keys, plan = _variant_step(cuda, variant, "random", split=counts,
                                              with_plan=with_plan)
    assert eng.K_r + eng.K_s + eng.K_l == counts[0]
    if counts[1] == 0:
        assert eng.K_s == 0
    if not with_plan:
        assert eng.cand.n_imp(eng.K_r, plan) == 0
    bufs, tails = _padded_buffers(eng.cand, cuda)
    got = _candidates_against_plain(cuda, eng, carry, g, keys, plan, False, some_accepted=False)
    again = cand_k.candidates(eng.cand, eng.statics, carry, keys, g, plan, 0.0, bufs=bufs)
    torch.cuda.synchronize()
    for f in ("delta", "feas", "accept", "src", "dst", "part1", "part2"):
        assert torch.equal(again[f], got[f]), f
    for name in ("payr", "payl"):
        for f, t in got[name].items():
            assert torch.equal(again[name][f], t), (name, f)
    assert all(bool((t.view(torch.uint8) == 0xA5).all()) for t in tails)


def _padded_buffers(cp, device, pad: int = 64):
    """candidate_buffers whose every tensor is the head of one allocation
    `pad` rows longer, filled with 0xA5 bytes; and the tails, which show a
    store past a buffer's end."""
    bufs = cand_k.candidate_buffers(cp, device)
    tails = []

    def grow(t):
        big = torch.empty((t.shape[0] + pad, *t.shape[1:]), dtype=t.dtype, device=device)
        big.view(torch.uint8).fill_(0xA5)
        tails.append(big[t.shape[0]:])
        return big[: t.shape[0]]

    return {k: {f: grow(t) for f, t in bufs[k].items()} for k in ("out", "payr", "payl")}, tails


@pytest.mark.parametrize("rf", [1, 2, 3, 5, 9])
def test_candidates_member_widths(cuda, rf):
    """Member tables of width 1 to 9 (the scans and the first-leader search
    take a slot a lane, in several passes past a team's width)."""
    for variant in ("default", "prior"):
        eng, carry, g, keys, plan = _variant_step(cuda, variant, "random", rf=rf)
        assert int(eng.statics.part_replicas.shape[1]) == rf
        _candidates_against_plain(cuda, eng, carry, g, keys, plan, True)


def test_candidates_refuse_mixed_devices(cuda):
    eng, carry, g, _, keys, plan = _step_inputs(cuda)
    cpu_carry = carry.clone()
    cpu_carry.broker_load = cpu_carry.broker_load.cpu()
    with pytest.raises(ValueError):
        cand_k.candidates(eng.cand, eng.statics, cpu_carry, keys, g, plan, 0.0)


def test_segment_sum_adds_in_row_order(cuda):
    """The aggregates' float segment sums on the card equal the CPU's
    (row order, the reference's) bit for bit, call after call."""
    from cruise_control_tpu_torch.models.aggregates import segment_sum

    rng = np.random.default_rng(0)
    data = (10.0 ** rng.uniform(-2.0, 8.0, (50_000, 4))).astype(np.float32)
    seg = rng.integers(0, 37, 50_000)
    want = segment_sum(torch.from_numpy(data), torch.from_numpy(seg), 38)
    for _ in range(3):
        got = segment_sum(torch.from_numpy(data).to(cuda), torch.from_numpy(seg).to(cuda), 38)
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


# ----------------------------------------------------------------------
# the fused route's kernels: group_by_broker, refresh_aggregates,
# step_globals, round_schedule, and the round graph
# ----------------------------------------------------------------------


@pytest.mark.parametrize("case", ["replicas", "one_segment", "all_padding", "few_segments", "empty",
                                  "many_segments", "hot_segment"])
def test_group_matches_plain(cuda, case):
    from cruise_control_tpu_torch.kernels.group import group_by_broker, group_plain, Grouping

    rng = np.random.default_rng(len(case))
    n_seg, n = (25_000 if case == "many_segments" else 2600), 500_245
    seg = {
        "replicas": lambda: rng.integers(0, n_seg + 1, n),
        "one_segment": lambda: np.full(n, 7),
        "all_padding": lambda: np.full(n, n_seg),
        "few_segments": lambda: rng.choice([0, 1, 2599, n_seg], n),
        "empty": lambda: np.zeros(0),
        "many_segments": lambda: rng.integers(0, n_seg + 1, n),
        # 20,010 rows in segment 11, spread over every block's rows
        "hot_segment": lambda: np.where(np.arange(n) % 25 == 0, 11, rng.integers(0, n_seg + 1, n)),
    }[case]().astype(np.int32)
    t = torch.from_numpy(seg).to(cuda)
    before = kernels.LAUNCHES["group_by_broker"]
    got = group_by_broker(t, n_seg)
    assert kernels.LAUNCHES["group_by_broker"] == before + 1
    want = group_plain(t, n_seg, Grouping.empty(len(seg), n_seg, cuda))
    for f in ("count", "start", "order"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("case", ["engine", "random"])
def test_group_placement_matches_plain(cuda, case):
    """The broker/valid entry (the engine's call): the kernel computes each
    row's segment itself; exactly the plain grouping of
    placement_segments, three calls into one grouping."""
    from cruise_control_tpu_torch.kernels.group import (
        Grouping,
        group_placement,
        group_plain,
        placement_segments,
    )

    if case == "engine":
        eng, carry = _moved_carry(cuda)
        broker, valid, B = carry.replica_broker, eng.statics.state.replica_valid, eng.shape.B
    else:
        rng = np.random.default_rng(5)
        B, n = 2600, 500_245
        broker = torch.from_numpy(rng.integers(-2, B + 3, n).astype(np.int32)).to(cuda)
        valid = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    n = int(broker.shape[0])
    want = group_plain(placement_segments(broker, valid, B), B, Grouping.empty(n, B, cuda))
    out = Grouping.empty(n, B, cuda)
    for _ in range(3):
        for f in ("count", "start", "order"):
            getattr(out, f).fill_(-1)
        before = kernels.LAUNCHES["group_by_broker"]
        group_placement(broker, valid, B, out=out)
        assert kernels.LAUNCHES["group_by_broker"] == before + 1
        for f in ("count", "start", "order"):
            assert torch.equal(getattr(out, f), getattr(want, f)), f


def _moved_carry(cuda, steps=6):
    """A small cluster's carry a few greedy steps from its input (brokers
    hold moved rows, leaders changed), on the card (or the CPU)."""
    state = random_cluster(RandomClusterSpec(num_brokers=40, num_partitions=3000, skew=1.0), seed=4,
                           device=cuda)
    eng = Engine(state, DEFAULT_CHAIN, config=CFG)
    carry = eng.init_carry(Key.from_seed(1))
    for _ in range(steps):
        carry, _ = eng.step(carry, 0.0)
    return eng, carry


def test_refresh_matches_plain_bitwise(cuda):
    """The card's aggregates equal the plain version's on the CPU (row
    order, the reference's) bit for bit, run after run.  (The plain version
    on the card is no yardstick here: CUDA's index_put_ accumulation sums a
    one-column segment's rows in a tree.)"""
    from cruise_control_tpu_torch.kernels.refresh import AGG_FIELDS, refresh_aggregates, refresh_plain

    eng, carry = _moved_carry(cuda)
    st = eng.statics.state
    place = (carry.replica_broker, carry.replica_is_leader, carry.replica_disk)
    cpu = Engine(random_cluster(RandomClusterSpec(num_brokers=40, num_partitions=3000, skew=1.0), seed=4,
                                device="cpu"), DEFAULT_CHAIN, config=CFG).statics
    want = {f: torch.empty_like(t, device="cpu") for f, t in carry.aggregates().items()}
    refresh_plain(cpu.state, *[t.cpu() for t in place], want, cpu.host_groups)
    want = {f: t.to(cuda) for f, t in want.items()}
    for _ in range(3):
        got = {f: torch.full_like(t, -1) for f, t in carry.aggregates().items()}
        before = kernels.LAUNCHES["refresh_aggregates"]
        refresh_aggregates(st, *place, got, hosts=eng.statics.host_groups)
        assert kernels.LAUNCHES["refresh_aggregates"] == before + 1
        for f in (*AGG_FIELDS, "host_load"):
            a, b = got[f], want[f]
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), f


def _to(x, device):
    """A dataclass of tensors (a cluster state, a grouping) on `device`."""
    import dataclasses

    return dataclasses.replace(x, **{
        f.name: v.to(device) for f in dataclasses.fields(x)
        for v in (getattr(x, f.name),) if isinstance(v, torch.Tensor)
    })


def _refresh_case(kind: str):
    """(CPU state, CPU placement) of a refresh case: a random cluster (JBOD
    for "jbod"), its placement with 20,000 rows on broker 0 ("hot_broker")
    or with every fifth broker emptied ("empty_brokers")."""
    D = 3 if kind == "jbod" else 1
    P = 12_000 if kind == "hot_broker" else 3000
    state = random_cluster(RandomClusterSpec(num_brokers=40, num_partitions=P, skew=1.0, disks_per_broker=D),
                           seed=5, device="cpu")
    broker = state.replica_broker.clone()
    disk = state.replica_disk.clone()
    if kind == "hot_broker":
        rows = torch.nonzero(state.replica_valid).flatten()[:20_000]
        assert rows.numel() == 20_000
        broker[rows] = 0
        disk[rows] = 0
    elif kind == "empty_brokers":
        broker = torch.where(broker % 5 == 0, broker + 1, broker)
    return state, (broker, state.replica_is_leader.clone(), disk)


@pytest.mark.parametrize("kind", ["no_hosts", "hosts_only", "jbod", "hot_broker", "empty_brokers"])
def test_refresh_cases_match_plain_bitwise(cuda, kind):
    """The card's refresh against the plain version on the CPU, bit for
    bit, three calls: without the host pass, the host pass alone
    (host_load's call), JBOD brokers, one broker holding 20,000 rows, and
    brokers holding none.  Cells a call must not write keep their -1."""
    from cruise_control_tpu_torch.kernels.refresh import (
        AGG_FIELDS,
        HostGroups,
        refresh_aggregates,
        refresh_plain,
    )
    from cruise_control_tpu_torch.models.aggregates import empty_aggregates

    state, place = _refresh_case(kind)
    s = state.shape
    hosts = None if kind == "no_hosts" else HostGroups.of(state.broker_valid, state.broker_host, s.num_hosts)
    want = empty_aggregates(state)
    want["host_load"] = torch.full((s.num_hosts, 4), -1.0)
    refresh_plain(state, *place, want, hosts)
    st, place_c = _to(state, cuda), [t.to(cuda) for t in place]
    hosts_c = None if hosts is None else HostGroups(hosts.seg.to(cuda), _to(hosts.group, cuda))
    members = st.members
    fields = ("broker_load", "host_load") if kind == "hosts_only" else (*AGG_FIELDS, "host_load")
    for _ in range(3):
        got = {f: torch.full_like(want[f], -1, device=cuda) for f in fields}
        if kind == "hosts_only":
            got["broker_load"].copy_(want["broker_load"])
        before = kernels.LAUNCHES["refresh_aggregates"]
        refresh_aggregates(st, *place_c, got, hosts=hosts_c, brokers=kind != "hosts_only", members=members)
        assert kernels.LAUNCHES["refresh_aggregates"] == before + 1
        for f in fields:
            a, b = got[f].cpu(), want[f]
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), f


def test_group_refresh_graph_replay(cuda):
    """group_placement and refresh_aggregates captured in one CUDA graph
    (two cooperative launches) and replayed over three changed placements:
    each replay's grouping exactly and aggregates bit for bit the plain
    versions' on the CPU (no stale scratch, no stale cells)."""
    from cruise_control_tpu_torch.kernels.group import Grouping, group_placement, group_plain, placement_segments
    from cruise_control_tpu_torch.kernels.refresh import (
        AGG_FIELDS,
        HostGroups,
        refresh_aggregates,
        refresh_plain,
    )
    from cruise_control_tpu_torch.models.aggregates import empty_aggregates

    state, place = _refresh_case("jbod")
    s = state.shape
    hosts = HostGroups.of(state.broker_valid, state.broker_host, s.num_hosts)
    st = _to(state, cuda)
    hosts_c = HostGroups(hosts.seg.to(cuda), _to(hosts.group, cuda))
    members = st.members
    broker, lead, disk = [t.to(cuda) for t in place]
    group = Grouping.empty(s.R, s.B, cuda)
    out = empty_aggregates(st)
    out["host_load"] = torch.empty((s.num_hosts, 4), device=cuda)

    def prep():
        group_placement(broker, st.replica_valid, s.B, out=group)
        refresh_aggregates(st, broker, lead, disk, out, hosts=hosts_c, group=group, members=members)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        prep()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        prep()
    rng = np.random.default_rng(0)
    valid = state.replica_valid.numpy()
    for _ in range(3):
        b = place[0].numpy().copy()
        moved = rng.random(s.R) < 0.2
        b[moved] = rng.integers(0, s.B, int(moved.sum()))
        d = np.where(moved, rng.integers(0, s.max_disks_per_broker, s.R), place[2].numpy()).astype(np.int32)
        ld = np.where(rng.random(s.R) < 0.1, ~place[1].numpy(), place[1].numpy())
        broker.copy_(torch.from_numpy(b))
        disk.copy_(torch.from_numpy(d))
        lead.copy_(torch.from_numpy(ld))
        for t in (*out.values(), group.count, group.start, group.order):
            t.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        bc, dc, lc = torch.from_numpy(b), torch.from_numpy(d), torch.from_numpy(ld)
        g_want = group_plain(placement_segments(bc, torch.from_numpy(valid), s.B), s.B,
                             Grouping.empty(s.R, s.B, "cpu"))
        for f in ("count", "start", "order"):
            assert torch.equal(getattr(group, f).cpu(), getattr(g_want, f)), f
        want = empty_aggregates(state)
        want["host_load"] = torch.empty((s.num_hosts, 4))
        refresh_plain(state, bc, lc, dc, want, hosts)
        for f in (*AGG_FIELDS, "host_load"):
            a, w = out[f].cpu(), want[f]
            if a.dtype == torch.float32:
                a, w = a.view(torch.int32), w.view(torch.int32)
            assert torch.equal(a, w), f


def test_round_prep_refuses_foreign_inputs(cuda):
    """A member table on the CPU beside a state on the card, and a grouping
    on the card without the kernel's scratch, raise before any launch."""
    from cruise_control_tpu_torch.kernels.group import Grouping, group_placement
    from cruise_control_tpu_torch.kernels.refresh import refresh_aggregates
    from cruise_control_tpu_torch.models.aggregates import empty_aggregates

    state, (broker, lead, disk) = _refresh_case("jbod")
    s = state.shape
    st = _to(state, cuda)
    broker, lead, disk = broker.to(cuda), lead.to(cuda), disk.to(cuda)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="all be on CUDA or all on the CPU"):
        refresh_aggregates(st, broker, lead, disk, empty_aggregates(st), members=state.members)
    bare = Grouping(*(torch.empty(n, dtype=torch.int32, device=cuda) for n in (s.B, s.B, s.R)))
    with pytest.raises(ValueError, match="Grouping.empty"):
        group_placement(broker, st.replica_valid, s.B, out=bare)
    assert kernels.LAUNCHES == before


def test_step_globals_matches_plain(cuda):
    from cruise_control_tpu_torch.kernels import step_globals as gk

    eng, carry = _moved_carry(cuda)
    T = eng.shape.num_topics
    want = gk.globals_plain(eng.statics, carry, torch.empty(gk.size(T), device=cuda))
    first = None
    for _ in range(3):
        buf = torch.full((gk.size(T),), float("nan"), device=cuda)
        before = kernels.LAUNCHES["step_globals"]
        got = gk.step_globals(eng.statics, carry, buf)
        assert kernels.LAUNCHES["step_globals"] == before + 1
        for k, v in want.items():
            assert torch.allclose(got[k], v, rtol=1e-6, atol=0.0), k
        first = buf.clone() if first is None else first
        assert torch.equal(buf.view(torch.int32), first.view(torch.int32))  # the same run after run


def _globals_case(B: int, T: int, D: int, device):
    """step_globals' inputs at B brokers (about one in five dead, broker 0
    alive), T topics and D disks a broker (about one in ten dead), as the
    (statics, carry) views the wrapper reads."""
    from types import SimpleNamespace

    rng = np.random.default_rng([B, T, D])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    alive = rng.random(B) < 0.8
    alive[0] = True
    cap = rng.uniform(50.0, 5e6, (B, 4)).astype(np.float32)
    state = SimpleNamespace(
        shape=SimpleNamespace(B=B, num_topics=T, max_disks_per_broker=D),
        broker_capacity=t(cap), disk_alive=t(rng.random((B, D)) < 0.9),
    )
    gen = md.Generation.empty(device)
    gen.write(md.Generation.host_words(None, cap[alive].sum(0), n_valid=1.0,
                                       n_alive=float(alive.sum()), total_disk_cap=1.0, n_source=1,
                                       n_dest=1, n_brokers=B, shared_hosts=False))
    sx = SimpleNamespace(state=state, alive=t(alive), total_cap=t(cap[alive].sum(0)), gen=gen)
    carry = SimpleNamespace(
        broker_load=t((cap * rng.uniform(0.0, 1.2, (B, 4))).astype(np.float32)),
        broker_replica_count=t(rng.integers(0, 400, B).astype(np.int32)),
        broker_leader_count=t(rng.integers(0, 200, B).astype(np.int32)),
        broker_leader_bytes_in=t(rng.uniform(0.0, 1e5, B).astype(np.float32)),
        broker_topic_count=t(rng.integers(0, 30, (T, B)).astype(np.int32)),
        disk_load=t(rng.uniform(0.0, 4e3, (B, D)).astype(np.float32)),
    )
    return sx, carry


@pytest.mark.parametrize("T", [1, 200, 1000])
@pytest.mark.parametrize("B", [1, 31, 2600, 25_000])
def test_step_globals_over_sizes(cuda, B, T):
    """rtol 1e-6 of the plain version with dead brokers and disks, and the
    same bits on each of 100 calls."""
    from cruise_control_tpu_torch.kernels import step_globals as gk

    sx, carry = _globals_case(B, T, 3, cuda)
    want = gk.globals_plain(sx, carry, torch.empty(gk.size(T), device=cuda))
    buf = torch.full((gk.size(T),), float("nan"), device=cuda)
    got = gk.step_globals(sx, carry, buf)
    for k, v in want.items():
        assert torch.allclose(got[k], v, rtol=1e-6, atol=0.0), k
    first = buf.clone()
    for _ in range(100):
        buf.fill_(float("nan"))
        gk.step_globals(sx, carry, buf)
        assert torch.equal(buf.view(torch.int32), first.view(torch.int32))


def test_round_schedule_matches_plain(cuda):
    """Each phase on the card against the plain version on the CPU, over a
    table of gate inputs (round, done, checks left, cheap signal, full-chain
    violation, previous violation, has-previous) and a decay whose powers
    are not exact."""
    import itertools

    from cruise_control_tpu_torch.kernels import schedule as sk

    tol = float(np.float32(1e-6))
    dims = sk.ScheduleDims(n_main=3, total=5, tol_on=True, checks=2, verbose=True, tol=tol,
                           scale=float(np.float32(1e-2)))
    table = itertools.product([0, 1, 2, 3, 4], [0, 1], [0, 1, 2], [0.0, tol, 1e-3, float("inf")],
                              [0.0, tol, 5e-4, 1e-3], [float("inf"), 1e-3, 5e-4], [0, 1])
    for row in table:
        states = []
        for dev in ("cpu", cuda):
            s = sk.Schedule.create(5, 0.7, dev)
            s.sf[sk.OBJ] = 37.0
            sk.round_schedule(sk.INIT, s, dims)
            rnd, done, checks, cheap_prev, full_v, prev_v, has_prev = row
            s.si[sk.RND], s.si[sk.DONE], s.si[sk.CHECKS], s.si[sk.HAS_PREV] = rnd, done, checks, has_prev
            s.sf[sk.CHEAP_PREV], s.sf[sk.PREV_V] = cheap_prev, prev_v
            sk.round_schedule(sk.GATE, s, dims)
            if s.si[sk.NEED_FULL]:
                s.sf[sk.FULL_V] = full_v
            sk.round_schedule(sk.DECIDE, s, dims)
            if s.si[sk.RUN]:
                s.acc += 11
                s.sf[sk.CHEAP] = 2e-3
                s.sf[sk.OBJ] = 5.0
            sk.round_schedule(sk.CLOSE, s, dims)
            states.append([t.cpu() for t in (s.si, s.sf, s.acc, s.ys)])
        for a, b in zip(*states):
            assert torch.equal(a, b) or (a.is_floating_point() and torch.allclose(a, b, equal_nan=True)
                                         and torch.equal(a.isnan(), b.isnan())), row


def test_graph_route_matches_legacy_at_t0(cuda):
    """The fused route on the card (captured graphs behind conditional
    nodes, one blocking sync) and the legacy host loop, which share every
    kernel: identical placements and rounds at T=0; the graph route's
    launches counted per replay."""
    import dataclasses

    state = random_cluster(RandomClusterSpec(num_brokers=20, num_partitions=400, skew=1.0), seed=2,
                           device=cuda)
    cfg = dataclasses.replace(CFG, init_temperature_scale=0.0, num_rounds=4)
    kernels.reset_launches()
    eng = Engine(state, DEFAULT_CHAIN, config=cfg)
    final_f, hist_f = eng.run()
    launches = dict(kernels.LAUNCHES)
    # a verbose run captures the objective graph and a second round graph
    again, hist_again = eng.run(verbose=True)
    legacy = Engine(state, DEFAULT_CHAIN, config=dataclasses.replace(cfg, fused_rounds=False))
    final_l, hist_l = legacy.run(verbose=True)
    assert [h["objective"] for h in hist_again if "round" in h] == \
        [h["objective"] for h in hist_l if "round" in h]
    rounds = [(h["round"], h["accepted"], h.get("early_stop"), h.get("extra")) for h in hist_f if "round" in h]
    assert rounds == [(h["round"], h["accepted"], h.get("early_stop"), h.get("extra"))
                      for h in hist_l if "round" in h]
    assert rounds == [(h["round"], h["accepted"], h.get("early_stop"), h.get("extra"))
                      for h in hist_again if "round" in h]
    for f in ("replica_broker", "replica_is_leader", "replica_disk"):
        assert torch.equal(getattr(final_f, f), getattr(final_l, f)), f
        assert torch.equal(getattr(final_f, f), getattr(again, f)), f
    timing = next(h for h in hist_f if h.get("timing"))
    assert timing["fused"] is True and timing["blocking_syncs"] == 1
    # one candidates launch per step that ran; the capture's warm-up step
    # counts into the capture's own record
    assert launches["candidates"] == cfg.steps_per_round * len(rounds)
    assert eng.graph_stats["captures"][0]["warmup_launches"]["candidates"] == 1
    # INIT in the init graph, three a loop iteration and EXIT (the capture's
    # warm-up INIT counts into the capture's record, as above)
    assert launches["round_schedule"] == 3 * timing["loop_iterations"] + 2
    assert eng.graph_stats["captures"][0]["nodes"]["body"][1] > 0


def test_round_schedule_exit_matches_plain(cuda):
    """The loop's phases on the card against the plain version on the CPU,
    the loop run as the graph runs it (until CLOSE clears `loop`, then
    EXIT) over scripted stops: in round 1, in the last main round, in a
    polish round, on a polish stall, and never; every state word, counter
    and ys row the same (NaN where the plain version has NaN)."""
    from cruise_control_tpu_torch.kernels import schedule as sk

    tol = float(np.float32(1e-6))
    big = 1e-2
    scripts = (
        ([tol] + [big] * 6, [big, 0.0] + [big] * 5),
        ([big, big, tol] + [big] * 4, [big, big, big, tol, big, big, big]),
        ([big] * 7, [big] * 4 + [1e-3, tol, big]),
        ([big] * 7, [big] * 4 + [1e-3, 9.5e-4, big]),
        ([big] * 7, [big] * 4 + [1e-3, 5e-4, 2e-4]),
    )
    for (cheap, full), verbose, decay in itertools.product(scripts, (False, True), (0.5, 0.7)):
        dims = sk.ScheduleDims(n_main=4, total=7, tol_on=True, checks=2, verbose=verbose, tol=tol,
                               scale=float(np.float32(1e-2)))
        states = []
        for dev in ("cpu", cuda):
            s = sk.Schedule.create(7, decay, dev)
            s.sf[sk.OBJ] = 37.0
            sk.round_schedule(sk.INIT, s, dims)
            while True:
                rnd = int(s.si[sk.RND])
                sk.round_schedule(sk.GATE, s, dims)
                if s.si[sk.NEED_FULL]:
                    s.sf[sk.FULL_V] = full[rnd]
                sk.round_schedule(sk.DECIDE, s, dims)
                if s.si[sk.RUN]:
                    s.acc += 7 + rnd
                    s.sf[sk.CHEAP] = cheap[rnd]
                    s.sf[sk.OBJ] = 3.0 / (rnd + 1)
                sk.round_schedule(sk.CLOSE, s, dims)
                if not s.si[sk.LOOP]:
                    break
            sk.round_schedule(sk.EXIT, s, dims)
            states.append([t.cpu() for t in (s.si, s.sf, s.acc, s.ys, s.count)])
        for a, b in zip(*states):
            assert torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())
        assert int(states[1][4][sk.MASKED]) == 0


#: the loop graph's cases on random_cluster(20/400): steps a round,
#: init_temperature_scale, verbose (and convergence diagnostics); 24 steps
#: stop in a main round, 8 in a polish round (on the CPU's trajectory as on
#: the card's)
LOOP_CASES = {
    "main_stop_t0": (24, 0.0, False),
    "main_stop_hot_verbose": (24, 1e-2, True),
    "polish_stop_t0_verbose": (8, 0.0, True),
    "polish_stop_hot": (8, 1e-2, False),
    "main_stop_hot_diag": (24, 1e-2, False, True),
    "polish_stop_t0_verbose_diag": (8, 0.0, True, True),
}


@pytest.mark.parametrize("name", LOOP_CASES)
def test_loop_graph_matches_round_eager(cuda, name):
    """One launch of the loop graph against the same schedule run round by
    round on the card (`_round_eager` until CLOSE clears `loop`, then
    EXIT), from the same workspace: the ys bytes, the final carry and the
    counted kernel launches are the same; the graph route launched one
    graph and ran no masked round."""
    from cruise_control_tpu_torch.kernels import schedule as sk

    steps, scale, verbose, *diag = LOOP_CASES[name]
    diag = bool(diag)
    state = random_cluster(RandomClusterSpec(num_brokers=20, num_partitions=400, skew=1.0), seed=2,
                           device=cuda)
    cfg = OptimizerConfig(num_candidates=256, leadership_candidates=64, steps_per_round=steps,
                          num_rounds=6, seed=1, init_temperature_scale=scale, diagnostics=diag)
    eng = Engine(state, DEFAULT_CHAIN, config=cfg)
    eng.run(verbose=verbose)  # captures the graphs
    kernels.reset_launches()
    final, hist = eng.run(verbose=verbose)
    torch.cuda.synchronize()
    graph_launches = dict(kernels.LAUNCHES)
    ws = eng._ws
    ys_graph = ws.sched.ys.clone()
    carry_graph = ws.carry.clone()
    timing = hist[-1]

    kernels.reset_launches()
    dims = eng._sched_dims(verbose)
    eng._init_run(ws, dims)
    rounds = 0
    while True:
        eng._round_eager(ws, dims)
        rounds += 1
        if not ws.sched.si[sk.LOOP]:
            break
    sk.round_schedule(sk.EXIT, ws.sched, dims)
    torch.cuda.synchronize()
    assert torch.equal(ys_graph.view(torch.int64), ws.sched.ys.view(torch.int64))
    for f in _tensor_fields(carry_graph):
        a, b = getattr(carry_graph, f), getattr(ws.carry, f)
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), f
    assert graph_launches == dict(kernels.LAUNCHES)
    assert timing["graph_launches"] == 1 and timing["blocking_syncs"] == 1
    assert timing["masked_rounds"] == 0 and timing["loop_iterations"] == rounds
    recs = [h for h in hist if "round" in h]
    if name.startswith("main_stop"):
        assert recs[-1].get("early_stop") is True and not recs[-1].get("extra")
    else:
        assert recs[-1].get("extra") is True and rounds < eng._n_rounds()
    assert ("objective" in recs[0]) == (verbose or diag)
    assert ("accepted_by_kind" in recs[0]) == diag


# ---------------------------------------------------------------------------
# the learned prior, bf16 scoring and convergence diagnostics
# ---------------------------------------------------------------------------


def _mode_step(cuda, *, prior_mix=None, bf16=False, jbod=False, seed=5):
    """One step's inputs of an engine with the prior (at `prior_mix`, a
    warm table of testing/fixtures.py `prior_table`) and/or bf16 scoring:
    random_cluster(20/400) with the default chain, or the JBOD fixture
    with configuration 3's chain (the disk terms)."""
    if jbod:
        state = fixtures.jbod_cluster(cuda)
        chain = GoalChain.from_names(list(CONFIG3_CHAIN))
    else:
        state = random_cluster(RandomClusterSpec(num_brokers=20, num_partitions=400, skew=1.0), seed=2,
                               device=cuda)
        chain = DEFAULT_CHAIN
    prior = None if prior_mix is None else fixtures.prior_table(state.shape, 1, prior_mix)
    cfg = dataclasses.replace(CFG, prior_enabled=prior is not None,
                              score_dtype="bfloat16" if bf16 else "float32")
    eng = Engine(state, chain, config=cfg, prior=prior)
    carry = eng.init_carry(Key.from_seed(seed))
    plan = eng.plan(carry)
    keys = cand_k.StepKeys.of(carry.key, prior=prior is not None)
    return eng, carry, eng._globals(carry), keys, plan


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("mix", [0.0, 0.5, 1.0])
def test_candidates_prior_matches_plain(cuda, mix, hot):
    """The prior variant against its plain version (the took-the-prior
    mask exact too); a cold prior's bundle is the prior-off engine's."""
    eng, carry, g, keys, plan = _mode_step(cuda, prior_mix=mix)
    assert eng.cand.prior and tuple(eng.statics.prior_cdf.shape) == (eng.shape.num_topics, eng.shape.B)
    got = _candidates_against_plain(cuda, eng, carry, g, keys, plan, hot)
    fp = got["from_prior"]
    assert fp.shape == (eng.K_r,)
    if mix == 0.0:
        assert not bool(fp.any())
        off = Engine(eng.statics.state, DEFAULT_CHAIN, config=CFG)
        base = cand_k.candidates(off.cand, off.statics, carry, cand_k.StepKeys.of(carry.key), g,
                                 plan, 0.0)
        for f in ("delta", "feas", "src", "dst") + (() if hot else ("accept",)):
            assert torch.equal(got[f], base[f]), f
    elif mix == 1.0:
        assert bool(fp.all())
    else:
        assert 0 < int(fp.sum()) < eng.K_r


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("case", ["default", "disk_terms", "prior"])
def test_candidates_bf16_matches_plain(cuda, case, hot):
    """The bf16 variant against the bf16 plain version: ids, masks and
    payload rows exact, deltas within the bar, acceptance equal away from
    the threshold; with the disk terms and with the prior too."""
    eng, carry, g, keys, plan = _mode_step(cuda, bf16=True, jbod=case == "disk_terms",
                                           prior_mix=0.5 if case == "prior" else None)
    assert eng.tp.bf16
    _candidates_against_plain(cuda, eng, carry, g, keys, plan, hot)


@pytest.mark.parametrize("with_prior", [False, True])
@pytest.mark.parametrize("case", SELECT_CASES)
def test_select_diag_counts_exact(cuda, case, with_prior):
    """The diagnostics instantiation: survivors and relocation mask exactly
    the plain version's, and its six counts (total, by kind, prior
    candidates and survivors) added exactly, into a fresh accumulator and
    over epochs of one buffer."""
    c = select_case(case)
    K, B, P, n_r, n_s = (c[k] for k in ("K", "B", "P", "n_r", "n_s"))
    g = torch.Generator().manual_seed(len(case))
    fp = (torch.rand(n_r, generator=g) < 0.4).to(cuda) if with_prior else None
    bufs = select_k.select_buffers(K, n_r, n_s, B, P, cuda, n_epochs=4)
    acc = torch.full((len(select_k.DIAG_FIELDS),), 3, dtype=torch.int64, device=cuda)
    for seed, epoch in ((0, 1), (1, 2), (2, 4)):
        args = _select_args(select_case(case, seed), cuda)
        before = acc.clone()
        got = select_k.select_survivors(*args, num_brokers=B, num_parts=P, n_r=n_r, n_s=n_s, acc=acc,
                                        bufs=bufs, epoch=select_k.Epoch(epoch - 1), from_prior=fp,
                                        diag=True)
        want = select_k.select_plain(*args, B, P, n_r, n_s, from_prior=fp, diag=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert (acc - before).tolist() == want[2].tolist()
        assert int(want[2][0]) == int(want[2][1:4].sum())


def test_round_schedule_diag_matches_plain(cuda):
    """The diagnostics' schedule on the card against the plain version on
    the CPU, the loop run as the graph runs it, EXIT included, over the
    stops of test_round_schedule_exit_matches_plain: the counts and the
    stage copied into the rows of rounds that ran, 0 counts and NaN
    violations elsewhere; every word the same."""
    from cruise_control_tpu_torch.kernels import schedule as sk

    tol = float(np.float32(1e-6))
    big = 1e-2
    scripts = (
        ([tol] + [big] * 6, [big, 0.0] + [big] * 5),
        ([big] * 7, [big] * 4 + [1e-3, 9.5e-4, big]),
        ([big] * 7, [big] * 4 + [1e-3, 5e-4, 2e-4]),
    )
    G = 3
    for (cheap, full), verbose in itertools.product(scripts, (False, True)):
        dims = sk.ScheduleDims(n_main=4, total=7, tol_on=True, checks=2, verbose=verbose, tol=tol,
                               scale=float(np.float32(1e-2)), diag=True, n_goals=G)
        states = []
        for dev in ("cpu", cuda):
            s = sk.Schedule.create(7, 0.7, dev, diag=True, n_goals=G)
            s.sf[sk.OBJ] = 37.0
            sk.round_schedule(sk.INIT, s, dims)
            while True:
                rnd = int(s.si[sk.RND])
                sk.round_schedule(sk.GATE, s, dims)
                if s.si[sk.NEED_FULL]:
                    s.sf[sk.FULL_V] = full[rnd]
                sk.round_schedule(sk.DECIDE, s, dims)
                if s.si[sk.RUN]:
                    s.acc += torch.tensor([12 + rnd, 5, 4, 3 + rnd, 9, 2], dtype=torch.int64, device=dev)
                    s.sf[sk.CHEAP] = cheap[rnd]
                    s.stage.copy_(torch.tensor([3.0 / (rnd + 1), 0.5, 0.0, 1e-7 * rnd]))
                sk.round_schedule(sk.CLOSE, s, dims)
                if not s.si[sk.LOOP]:
                    break
            sk.round_schedule(sk.EXIT, s, dims)
            states.append([t.cpu() for t in (s.si, s.sf, s.acc, s.ys, s.count)])
        for a, b in zip(*states):
            assert torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())
        ys = states[1][3]
        ran = ys[:, 1] == 1
        assert bool(ran.any()) and bool(ys[~ran][:, -G:].isnan().all())
        assert bool((ys[ran][:, 7:10].sum(1) == ys[ran][:, 0]).all())


@pytest.mark.parametrize("mode", ["diagnostics", "prior", "bf16"])
def test_mode_runs_on_card(cuda, mode):
    """Each mode through the fused route on the card: one graph launch and
    one sync; with diagnostics, the placements of the run without them
    and accepted == sum(accepted_by_kind) on every round; with the prior,
    `rebind_prior` refills the statics with no new capture and the run
    equals a new engine's with that prior; with bf16, a valid placement
    whose objective falls."""
    state = random_cluster(RandomClusterSpec(num_brokers=20, num_partitions=400, skew=1.0), seed=2,
                           device=cuda)
    kw = {"diagnostics": dict(diagnostics=True), "prior": dict(prior_enabled=True),
          "bf16": dict(score_dtype="bfloat16")}[mode]
    cfg = dataclasses.replace(CFG, num_rounds=4, **kw)
    prior = fixtures.prior_table(state.shape, 2, 0.5) if mode == "prior" else None
    eng = Engine(state, DEFAULT_CHAIN, config=cfg, prior=prior)
    final, hist = eng.run()
    timing = hist[-1]
    assert timing["graph_launches"] == 1 and timing["blocking_syncs"] == 1
    if mode == "diagnostics":
        base, _ = Engine(state, DEFAULT_CHAIN, config=dataclasses.replace(cfg, diagnostics=False)).run()
        for f in ("replica_broker", "replica_is_leader", "replica_disk"):
            assert torch.equal(getattr(final, f), getattr(base, f)), f
        for rec in hist[:-1]:
            assert rec["accepted"] == sum(rec["accepted_by_kind"].values())
            assert len(rec["goal_violations"]) == len(DEFAULT_CHAIN.goals)
        assert timing["convergence"]["rounds"] == len(hist) - 1
    elif mode == "prior":
        captures = len(eng.graph_stats.get("captures", []))
        other = fixtures.prior_table(state.shape, 3, 1.0)
        eng.rebind_prior(other)
        again, hist2 = eng.run()
        assert len(eng.graph_stats.get("captures", [])) == captures and hist2[-1]["captured"] == []
        fresh, _ = Engine(state, DEFAULT_CHAIN, config=cfg, prior=other).run()
        for f in ("replica_broker", "replica_is_leader", "replica_disk"):
            assert torch.equal(getattr(again, f), getattr(fresh, f)), f
    else:
        from cruise_control_tpu_torch.models import validate

        assert validate(final, strict=False) == []
        assert float(DEFAULT_CHAIN.evaluate(final)[0]) < float(DEFAULT_CHAIN.evaluate(state)[0])


@pytest.mark.parametrize("case", ["empty", "one", "subset", "all", "sentinels"])
def test_scatter_loads_matches_plain(cuda, case):
    """scatter_loads against its plain version, bit for bit, from a staging
    buffer larger than the window (the count read on the device): no row,
    one row, a random subset, every row, and sentinel, negative and
    out-of-range rows among real ones; one launch a call."""
    from cruise_control_tpu_torch.kernels import scatter as scatter_k

    R, cap = 50_000, 60_000
    rng = np.random.default_rng(11)
    n = {"empty": 0, "one": 1, "subset": 7_000, "all": R, "sentinels": 9_000}[case]
    rows = np.full(cap, R, np.int32)
    rows[:n] = rng.permutation(R)[:n] if n else rows[:0]
    if case == "sentinels":
        # rows counted from the end (as a JAX index is) name their own row,
        # so the window's rows stay unique; the rest are dropped
        rows[2:n:13] -= R
        rows[:n:7] = R
        rows[1:n:11] = rng.integers(R + 1, 2 * R, rows[1:n:11].size)
        rows[3:n:17] = -R - 5
    new = rng.random((2, cap, 4), dtype=np.float32)
    base = rng.random((2, R, 4), dtype=np.float32)
    args = [torch.from_numpy(rows).to(cuda), *(torch.from_numpy(x).to(cuda) for x in new),
            torch.tensor([n], dtype=torch.int32, device=cuda)]
    got = [torch.from_numpy(b.copy()).to(cuda) for b in base]
    want = [t.clone() for t in got]
    before = kernels.LAUNCHES["scatter_loads"]
    scatter_k.scatter_loads(*got, *args)
    assert kernels.LAUNCHES["scatter_loads"] == before + 1
    scatter_k.scatter_loads_plain(*want, *args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    changed = int((got[0] != torch.from_numpy(base[0]).to(cuda)).any(1).sum())
    assert (changed == 0) == (n == 0)


def test_steady_state_cycle_captures_nothing(cuda):
    """The streaming cycle on the card: the first optimize of a model
    generation captures every graph a cycle replays; each later cycle
    captures nothing, launches the loop graph once and the two report graphs
    once each, makes one blocking sync and counts exactly its two
    dispatches; and it publishes the staged path's placements, live loads
    and reports bit for bit."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.common.dispatch import dispatch_meter
    from cruise_control_tpu_torch.models.whatif import LiveState

    state = random_cluster(RandomClusterSpec(num_brokers=20, num_partitions=400, skew=1.0), seed=2,
                           device=cuda)
    cfg = dataclasses.replace(CFG, prior_enabled=True)
    prior = fixtures.prior_table(state.shape, 2, 0.5)
    paths = [GoalOptimizer(config=cfg, device=cuda) for _ in range(2)]
    lives = [LiveState(dataclasses.replace(state, replica_load_leader=state.replica_load_leader.clone(),
                                           replica_load_follower=state.replica_load_follower.clone()))
             for _ in range(2)]
    res = [opt.optimize(live.state, prior=prior) for opt, live in zip(paths, lives)]
    first = next(h for h in res[0].history if h.get("timing"))
    assert {"init", "pre", "post"} <= set(first["captured"])
    valid = state.replica_valid.cpu().numpy()
    part = state.replica_partition.cpu().numpy()
    ll0 = state.replica_load_leader.cpu().numpy()
    fl0 = state.replica_load_follower.cpu().numpy()
    PL = ("replica_broker", "replica_is_leader", "replica_disk")
    for w, (every, factor) in enumerate(((3, 1.2), (1, 1.03), (5, 0.9))):
        rows = np.nonzero(valid & (part % every == w % every))[0].astype(np.int32)
        ll, fl = ll0[rows] * np.float32(factor), fl0[rows] * np.float32(factor)
        warm = [tuple(getattr(r.state_after, f) for f in PL) for r in res]
        with dispatch_meter() as m:
            fused, (n_ll, n_fl) = paths[0].optimize_streaming_cycle(
                lives[0].state, rows=rows, leader_loads=ll, follower_loads=fl,
                initial_placement=warm[0], prior=prior)
        lives[0].adopt_loads(n_ll, n_fl)
        assert m.counts == {"engine.cycle": 1, "engine.extract": 1}
        t = next(h for h in fused.history if h.get("timing"))
        assert t["captured"] == [] and t["graph_launches"] == 1 and t["report_graph_launches"] == 2
        assert t["blocking_syncs"] == 1 and t["fused_cycle"]
        lives[1].set_partition_loads(rows, ll, fl)
        staged = paths[1].optimize(lives[1].state, initial_placement=warm[1], prior=prior)
        assert next(h for h in staged.history if h.get("timing"))["captured"] == []
        for f in PL:
            assert torch.equal(getattr(fused.state_after, f), getattr(staged.state_after, f)), (w, f)
        for f in ("replica_load_leader", "replica_load_follower"):
            assert torch.equal(getattr(lives[0].state, f), getattr(lives[1].state, f)), (w, f)
        assert fused.objective_before == staged.objective_before
        assert fused.objective_after == staged.objective_after
        assert len(fused.proposals) == len(staged.proposals)
        res = [fused, staged]


@pytest.mark.parametrize("i,n", [(0, 5), (4, 5), (7, 5), (3, 40), (-1, 3), (0, 0)])
def test_scenario_step_matches_plain(cuda, i, n):
    """scenario_step against its plain version: row i stored when i < n
    (n clamped to the capacity), i advanced; exact."""
    from cruise_control_tpu_torch.kernels import scenario as scen_k

    loops = {}
    for dev in (cuda, torch.device("cpu")):
        s = scen_k.ScenarioLoop.create(32, 16, dev)
        s.obj_slot.fill_(3.5)
        s.viol_slot.copy_(torch.arange(16, dtype=torch.float32))
        s.obj_out.fill_(-1.0)
        s.ctrl.copy_(torch.tensor([i, n], dtype=torch.int32))
        before = kernels.LAUNCHES["scenario_step"]
        more = scen_k.scenario_step(s)
        if dev.type == "cuda":
            assert more is None and kernels.LAUNCHES["scenario_step"] == before + 1
        else:
            assert more == (i + 1 < min(n, 32))
        loops[dev.type] = s
    torch.cuda.synchronize()
    for f in ("ctrl", "obj_out", "viol_out"):
        assert torch.equal(getattr(loops["cuda"], f).cpu(), getattr(loops["cpu"], f)), f


def _scenario_batch(device):
    from cruise_control_tpu_torch.planner import BrokerAdd, Scenario, apply_scenario, plan_shape

    spec = RandomClusterSpec(num_brokers=24, num_partitions=600, num_racks=6, num_topics=12, skew=0.8)
    st = fixtures.random_cluster_fast(spec, seed=7, device=device)
    scs = []
    for i in range(12):
        kind = i % 4
        if kind == 0:
            scs.append(Scenario(name=f"kill-{i}", kill_racks=(i % 6,)))
        elif kind == 1:
            scs.append(Scenario(name=f"add-{i}", add_brokers=(BrokerAdd(count=1 + i % 3),)))
        elif kind == 2:
            scs.append(Scenario(name=f"rm-{i}", remove_brokers=(i % 24,)))
        else:
            scs.append(Scenario(name=f"scale-{i}", topic_load_factors={i % 12: 1.0 + 0.25 * (i % 5)}))
    shape = plan_shape(st, scs)
    from cruise_control_tpu_torch.models.builder import pad_state

    base = pad_state(st, shape)
    return base, [apply_scenario(base, sc, shape=shape) for sc in scs]


def test_scenario_batch_graph_equals_single_eval(cuda):
    """The batch graph on the card: one graph launch and one sync a batch,
    every scenario's objective and violations those of scoring it alone
    (bit for bit), the step kernel launched once a scenario, no capture on
    a second batch of another size; the card's numbers within the chain's
    bar of the CPU's."""
    from cruise_control_tpu_torch.analyzer import ScenarioEvaluator
    from cruise_control_tpu_torch.common.dispatch import dispatch_meter

    base, states = _scenario_batch(cuda)
    ev = ScenarioEvaluator(device=cuda)
    before = kernels.LAUNCHES["scenario_step"]
    with dispatch_meter() as m:
        obj, viol, _ = ev.evaluate_states(states)
    assert m.counts == {"scenario.batch": 1, "scenario.sync": 1}
    assert kernels.LAUNCHES["scenario_step"] == before + len(states)
    assert ev.last_batch["captured"] and ev.last_batch["graph_launches"] == 1
    # the loop's counter, read back from the device: the scenarios it ran
    assert ev.last_batch["steps"] == len(states)
    body = ev.last_batch["body_launches"]
    assert body.get("group_by_broker") and body.get("refresh_aggregates"), body
    for i, s in enumerate(states):
        o, v = ev._single_eval(s)
        assert float(o) == obj[i], i
        assert np.array_equal(np.asarray(v, np.float64), viol[i]), i
    with dispatch_meter() as m:
        obj2, _, _ = ev.evaluate_states(states[3:10])
    assert m.counts == {"scenario.batch": 1, "scenario.sync": 1}
    assert not ev.last_batch["captured"] and ev.last_batch["steps"] == 7
    assert np.array_equal(obj2, obj[3:10])
    _, cpu_states = _scenario_batch(torch.device("cpu"))
    obj_cpu, _, _ = ScenarioEvaluator(device="cpu").evaluate_states(cpu_states)
    np.testing.assert_allclose(obj, obj_cpu, rtol=1e-5)


def test_score_state_graph_equals_eager(cuda):
    """score_state's captured graph on the card: the chain and the stats of
    the eager evaluation, bit for bit, one sync a call."""
    from cruise_control_tpu_torch.analyzer import ScenarioEvaluator
    from cruise_control_tpu_torch.common.dispatch import dispatch_meter
    from cruise_control_tpu_torch.models.stats import compute_stats

    base, states = _scenario_batch(cuda)
    ev = ScenarioEvaluator(device=cuda)
    for s in (base, states[1], base):
        with dispatch_meter() as m:
            obj, viol, stats, _ = ev.score_state(s)
        assert m.counts == {"scenario.score": 1, "scenario.sync": 1}
        o, v = ev._single_eval(s)
        assert obj == float(o) and np.array_equal(viol, np.asarray(v, np.float64))
        want = compute_stats(s)
        for f in dataclasses.fields(stats):
            assert torch.equal(getattr(stats, f.name), getattr(want, f.name).cpu()), f.name


def _generation(state, kind: str):
    """Another model generation of the state's shape: three brokers dead
    (liveness, n_alive, capacity totals, destinations, offline rows), two
    brokers on one host (shared_hosts), or other capacities (the capacity
    totals and their weights)."""
    if kind == "dead_brokers":
        alive = state.broker_alive.clone()
        alive[-3:] = False
        offline = state.replica_valid & ~alive[state.replica_broker]
        return dataclasses.replace(state, broker_alive=alive, disk_alive=state.disk_alive & alive[:, None],
                                   replica_offline=state.replica_offline | offline)
    if kind == "shared_hosts":
        host = state.broker_host.clone()
        host[1] = host[0]
        return dataclasses.replace(state, broker_host=host)
    return dataclasses.replace(state, broker_capacity=state.broker_capacity * 1.7)


@pytest.mark.parametrize("kind", ["dead_brokers", "shared_hosts", "capacity"])
@pytest.mark.parametrize("variant", ["default", "disk_terms"])
def test_rebound_generation_kernels_match_plain(cuda, variant, kind):
    """After a rebind to another generation of the shape, the kernels read
    the generation block's new values: candidates, step_globals and
    apply_moves against their plain versions on the new generation's step,
    and the engine's captured graphs replay the new generation: its run is
    a fresh engine's, bit for bit."""
    from types import SimpleNamespace

    from cruise_control_tpu_torch.kernels import step_globals as gk

    eng, *_ = _variant_step(cuda, variant, "random")
    eng.run()  # captures the graphs on the first generation
    words = eng.statics.gen.words
    gen = _generation(eng._state, kind)
    eng.rebind(gen)
    assert eng.statics.gen.words is words and eng._ws.graphs
    if kind == "shared_hosts":
        assert eng.statics.gen.values()["shared_hosts"] == 1
    carry = eng.init_carry(Key.from_seed(7))
    plan = eng.plan(carry)
    g = eng._globals(carry)
    keys = cand_k.StepKeys.of(carry.key, intra=False, prior=False)
    prop = _candidates_against_plain(cuda, eng, carry, g, keys, plan, True, some_accepted=False)
    T = eng.shape.num_topics
    want = gk.globals_plain(eng.statics, carry, torch.empty(gk.size(T), device=cuda))
    got = gk.step_globals(eng.statics, carry, torch.empty(gk.size(T), device=cuda))
    for k, v in want.items():
        assert torch.allclose(got[k], v, rtol=1e-6, atol=0.0), k
    nr, ns = prop["nr"], prop["ns"]
    survive, sv_r, _ = select_k.select_survivors(
        prop["accept"], prop["delta"], prop["src"], prop["dst"], prop["part1"], prop["part2"],
        num_brokers=eng.shape.B, num_parts=eng.shape.P, n_r=nr, n_s=ns,
    )
    # the plain scatter on the CPU, which adds in the reference's order
    # where a host holds several brokers (CUDA's index_add_ would not)
    ck, cp = carry.clone(), _to(carry, "cpu")
    sx_cpu = SimpleNamespace(state=_to(eng.statics.state, "cpu"))
    apply_k.apply_moves(eng.statics, ck, sv_r, prop["payr"], survive[nr + ns:], prop["payl"])
    apply_k.apply_plain(sx_cpu, cp, sv_r.cpu(), {k: v.cpu() for k, v in prop["payr"].items()},
                        survive[nr + ns:].cpu(), {k: v.cpu() for k, v in prop["payl"].items()})
    for f in _tensor_fields(ck):
        assert torch.equal(getattr(ck, f).cpu(), getattr(cp, f)), f
    final, hist = eng.run()
    assert next(h for h in hist if h.get("timing"))["captured"] == []
    fresh, fresh_hist = Engine(gen, eng.chain, config=eng.config).run()
    for f in ("replica_broker", "replica_is_leader", "replica_disk"):
        assert torch.equal(getattr(final, f), getattr(fresh, f)), f
    assert [h for h in hist if "round" in h] == [h for h in fresh_hist if "round" in h]


#: the generation replays' search: short, so that each generation's fresh
#: engine is cheap
GEN_SEARCH = dict(num_candidates=256, leadership_candidates=64, steps_per_round=8, num_rounds=2)
#: the generation block's values that the sequence's generations change
GEN_CHANGED = ("n_valid", "n_alive", "total_disk_cap", "total_cap_nw_out", "n_source", "n_dest",
               "n_brokers", "shared_hosts")


def _generation_base() -> tuple[dict, dict]:
    """The first generation of `fixtures.generation_sequence` as host arrays
    and its shape: a small JBOD cluster with padding replica rows, padded by
    two brokers (one made real by the n_brokers generation)."""
    from cruise_control_tpu_torch.models.builder import pad_state
    from cruise_control_tpu_torch.models.state import STATE_FIELDS

    spec = RandomClusterSpec(num_brokers=8, num_racks=3, num_topics=4, num_partitions=30, skew=1.0,
                             disks_per_broker=2, replica_capacity=96)
    st = random_cluster(spec, seed=5, device="cpu")
    s = st.shape
    st = pad_state(st, dataclasses.replace(s, num_brokers=s.num_brokers + 2, num_hosts=s.num_hosts + 2))
    return {f: getattr(st, f).numpy().copy() for f in STATE_FIELDS}, dataclasses.asdict(st.shape)


def _graph_inputs(eng) -> dict:
    """data_ptr of every tensor the engine's graphs read of its statics,
    its state, its generation block and its host grouping, by name."""
    from cruise_control_tpu_torch.models.state import STATE_FIELDS

    sx = eng.statics
    out = {f"state.{f}": getattr(sx.state, f) for f in STATE_FIELDS}
    out.update({f.name: getattr(sx, f.name) for f in dataclasses.fields(sx)
                if isinstance(getattr(sx, f.name), torch.Tensor)})
    out["gen.words"] = sx.gen.words
    out["host_groups.seg"] = sx.host_groups.seg
    out.update({f"host_groups.{f}": getattr(sx.host_groups.group, f) for f in ("count", "start", "order")})
    return {k: t.data_ptr() for k, t in out.items()}


def _captured(history) -> list:
    return next(h for h in history if h.get("timing"))["captured"]


@pytest.mark.parametrize("variant", CAND_VARIANTS)
def test_generations_replay_in_captured_graphs(cuda, variant):
    """One engine of each candidates variant captures its graphs on the
    first generation of `fixtures.generation_sequence` and is rebound
    through the rest (the loads, liveness, capacities, offline rows,
    n_valid, n_source with a hole, n_dest, n_brokers, shared_hosts): each
    rebind keeps every tensor the graphs read, each run replays them with
    no capture, and each run is bit for bit a fresh engine's on the same
    generation (which captures its own)."""
    from cruise_control_tpu_torch.analyzer.options import OptimizationOptions
    from cruise_control_tpu_torch.convert import from_jax_arrays

    base, shape = _generation_base()
    first = from_jax_arrays(base, cuda, shape=shape)
    chain, cfg, prior = _variant_engine(variant, first, **GEN_SEARCH)
    eng = Engine(first, chain, config=cfg, prior=prior)
    _, hist = eng.run()
    assert _captured(hist)
    ws, ptrs = eng._ws, _graph_inputs(eng)
    seen = [eng.statics.gen.values()]
    for name, a, opts in fixtures.generation_sequence(base):
        st = from_jax_arrays(a, cuda, shape=shape)
        options = OptimizationOptions(**opts)
        eng.rebind(st, options, prior=prior)
        assert eng._ws is ws and _graph_inputs(eng) == ptrs, name
        final, hist = eng.run()
        assert _captured(hist) == [], name
        fresh, fresh_hist = Engine(st, chain, options=options, config=cfg, prior=prior).run()
        assert _captured(fresh_hist), name
        for f in ("replica_broker", "replica_is_leader", "replica_disk"):
            assert torch.equal(getattr(final, f), getattr(fresh, f)), (name, f)
        assert [h for h in hist if "round" in h] == [h for h in fresh_hist if "round" in h], name
        seen.append(eng.statics.gen.values())
    changed = [f for f in GEN_CHANGED if len({v[f] for v in seen}) > 1]
    assert changed == list(GEN_CHANGED)


def test_alternating_widths_capture_once_each(cuda):
    """Generations of one shape that alternate between two member-table
    widths (max_rf) through one GoalOptimizer: the first request of each
    width captures its engine's graphs, no later one captures, and each is
    a fresh optimizer's run; the bucket is billed two captures."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.analyzer.prewarm import bucket_key
    from cruise_control_tpu_torch.models.builder import prewarm_state
    from cruise_control_tpu_torch.models.state import member_width

    state = random_cluster(RandomClusterSpec(num_brokers=20, num_partitions=400, skew=1.0), seed=2,
                           device=cuda)
    wide = prewarm_state(state.shape, max_rf=member_width(state) + 1, device=cuda)
    cfg = dataclasses.replace(CFG, **GEN_SEARCH)
    want = {id(st): GoalOptimizer(config=cfg, device=cuda).optimize(st) for st in (state, wide)}
    opt = GoalOptimizer(config=cfg, device=cuda)
    captured = []
    for st in (state, wide, state, wide, state):
        res = opt.optimize(st)
        captured.append(bool(_captured(res.history)))
        for f in ("replica_broker", "replica_is_leader", "replica_disk"):
            assert torch.equal(getattr(res.state_after, f), getattr(want[id(st)].state_after, f)), f
    assert captured == [True, True, False, False, False]
    assert opt.compile_attribution()[bucket_key(state.shape)]["compiles"] == 2


# ---------------------------------------------------------------------------
# segmented execution: the slice end and the slice graph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ends", [[1, 2, 3, 4, 5, 6, 7], [2, 4, 8], [3, 100]])
def test_round_schedule_slice_end_matches_plain(cuda, ends):
    """The loop's phases driven launch by launch, each launch ending at the
    host's slice end (CLOSE stops at min(total, slice end); EXIT writes
    only once the run is over), on the card against the plain version on
    the CPU over test_round_schedule_exit_matches_plain's scripted stops;
    every state word, counter and ys row the same, and the ys those of
    the whole run in one launch (NaN where the plain version has NaN)."""
    from cruise_control_tpu_torch.kernels import schedule as sk

    tol = float(np.float32(1e-6))
    big = 1e-2
    scripts = (
        ([tol] + [big] * 6, [big, 0.0] + [big] * 5),
        ([big] * 7, [big] * 4 + [1e-3, tol, big]),
        ([big] * 7, [big] * 4 + [1e-3, 5e-4, 2e-4]),
    )
    dims = sk.ScheduleDims(n_main=4, total=7, tol_on=True, checks=2, verbose=False, tol=tol,
                           scale=float(np.float32(1e-2)))

    def drive(dev, cheap, full, slice_ends):
        s = sk.Schedule.create(7, 0.7, dev)
        s.sf[sk.OBJ] = 37.0
        sk.round_schedule(sk.INIT, s, dims)
        for end in slice_ends:
            if end is not None:
                s.si[sk.SLICE_END] = end
            while True:
                rnd = int(s.si[sk.RND])
                sk.round_schedule(sk.GATE, s, dims)
                if s.si[sk.NEED_FULL]:
                    s.sf[sk.FULL_V] = full[rnd]
                sk.round_schedule(sk.DECIDE, s, dims)
                if s.si[sk.RUN]:
                    s.acc += 7 + rnd
                    s.sf[sk.CHEAP] = cheap[rnd]
                sk.round_schedule(sk.CLOSE, s, dims)
                if not s.si[sk.LOOP]:
                    break
            sk.round_schedule(sk.EXIT, s, dims)
            if s.si[sk.DONE] or int(s.si[sk.RND]) >= 7:
                break
        return [t.cpu() for t in (s.si, s.sf, s.acc, s.ys, s.count)]

    def same(a, b):
        return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())

    for cheap, full in scripts:
        cpu, card = drive("cpu", cheap, full, ends), drive(cuda, cheap, full, ends)
        assert all(same(a, b) for a, b in zip(cpu, card)), ends
        whole = drive(cuda, cheap, full, [None])
        assert same(card[3], whole[3]) and same(card[4], whole[4]), ends


@pytest.mark.parametrize("variant", CAND_VARIANTS + ("diagnostics",))
def test_segmented_run_matches_one_launch(cuda, variant):
    """A segmented run on the card (one-round slices: SegmentContext(1e-9),
    a checkpoint between every two) against the one-launch run of the same
    engine, in every candidates variant and with diagnostics: the
    placements, the round records, the ys bytes and the carry bit for bit;
    one slice graph launch and one sync a slice; the slice graph
    instantiated once and nothing captured by a segmented run; the
    counted launches the one-launch run's, plus one EXIT a slice."""
    from cruise_control_tpu_torch.analyzer.engine import SegmentContext, segmented_execution

    disks = variant in ("disk_terms", "intra")
    spec = RandomClusterSpec(num_brokers=20, num_partitions=400, skew=1.0,
                             disks_per_broker=2 if disks else 1)
    state = random_cluster(spec, seed=2, device=cuda)
    chain, cfg, prior = _variant_engine("default" if variant == "diagnostics" else variant, state,
                                        num_candidates=256, leadership_candidates=64,
                                        steps_per_round=8, num_rounds=4)
    cfg = dataclasses.replace(cfg, diagnostics=variant == "diagnostics")
    eng = Engine(state, chain, config=cfg, prior=prior)
    eng.run()  # captures the graphs
    kernels.reset_launches()
    one, one_hist = eng.run()
    torch.cuda.synchronize()
    one_launches = dict(kernels.LAUNCHES)
    ys_one, carry_one = eng._ws.sched.ys.clone(), eng._ws.carry.clone()
    checkpoints = []
    for again in (False, True):
        kernels.reset_launches()
        with segmented_execution(SegmentContext(1e-9, checkpoint=lambda: checkpoints.append(1))):
            seg, seg_hist = eng.run()
        torch.cuda.synchronize()
        t = seg_hist[-1]
        assert t["segmented"] and t["captured"] == [] and t["instantiated"] == ([] if again else ["slice"])
        assert t["graph_launches"] == t["blocking_syncs"] == t["segments"] > 1
        want = dict(one_launches, round_schedule=one_launches["round_schedule"] + t["segments"] - 1)
        assert dict(kernels.LAUNCHES) == want
        for f in ("replica_broker", "replica_is_leader", "replica_disk"):
            assert torch.equal(getattr(one, f), getattr(seg, f)), f
        assert [h for h in one_hist if "round" in h] == [h for h in seg_hist if "round" in h]
        assert torch.equal(ys_one.view(torch.int64), eng._ws.sched.ys.view(torch.int64))
        for f in _tensor_fields(carry_one):
            a, b = getattr(carry_one, f), getattr(eng._ws.carry, f)
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            assert torch.equal(a, b), f
    assert len(eng.graph_stats["slice_graphs"]) == 1
    assert len(eng.graph_stats["captures"]) == 1


def test_segmented_reported_run_payload_on_card(cuda):
    """`run_reported` in slices on the card: the last slice's launch runs
    the after-report and the checks and copies the payload, which equals
    the one-launch reported run's bit for bit; a sync a slice, no more."""
    from cruise_control_tpu_torch.analyzer.engine import SegmentContext, segmented_execution

    state = random_cluster(RandomClusterSpec(num_brokers=20, num_partitions=400, skew=1.0), seed=2,
                           device=cuda)
    eng = Engine(state, DEFAULT_CHAIN, config=dataclasses.replace(CFG, num_rounds=4))
    f1, h1, p1 = eng.run_reported()
    with segmented_execution(SegmentContext(1e-9)):
        f2, h2, p2 = eng.run_reported()
    for f in ("replica_broker", "replica_is_leader", "replica_disk"):
        assert torch.equal(getattr(f1, f), getattr(f2, f)), f
    assert [h for h in h1 if "round" in h] == [h for h in h2 if "round" in h]
    for k in p1:
        if k.startswith("stats_"):
            for fld in dataclasses.fields(p1[k]):
                a, b = getattr(p1[k], fld.name), getattr(p2[k], fld.name)
                assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (k, fld.name)
        else:
            a, b = (np.asarray(p[k]).reshape(-1).view(np.uint8) for p in (p1, p2))
            assert np.array_equal(a, b), k
    t = h2[-1]
    assert t["segmented"] and t["blocking_syncs"] == t["segments"] and t["report_graph_launches"] == 2


# ---------------------------------------------------------------- supervision


def _spin_cycles_per_ms(dev) -> float:
    """The card's clock, measured: cycles of `torch.cuda._sleep` a ms."""
    torch.cuda._sleep(1000)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(50_000_000)
    end.record()
    end.synchronize()
    return 50_000_000 / start.elapsed_time(end)


def test_probe_runs_on_its_own_stream(cuda):
    """The watchdog's probe does not wait behind other work on the card:
    with the current stream spinning ~3 s, it answers healthy at once."""
    import time

    from cruise_control_tpu_torch.common.device_watchdog import device_watchdog

    assert device_watchdog(30.0, device=cuda) is None  # warm: the stream pool, the allocator
    torch.cuda._sleep(int(3000 * _spin_cycles_per_ms(cuda)))
    t0 = time.monotonic()
    diagnosis = device_watchdog(30.0, device=cuda)
    took = time.monotonic() - t0
    spinning = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert diagnosis is None and spinning and took < 1.0, (diagnosis, spinning, took)


def test_real_oom_classifies_as_oom(cuda):
    """The caching allocator's own out-of-memory error is OOM, through the
    supervisor too, and leaves the allocator's bytes as they were."""
    from cruise_control_tpu_torch.common.device_watchdog import (
        BreakerState,
        DeviceDegradedError,
        DeviceSupervisor,
        FailureClass,
        classify_failure,
    )

    too_many = torch.cuda.get_device_properties(cuda).total_memory + 1
    before = torch.cuda.memory_allocated(cuda)
    with pytest.raises(torch.cuda.OutOfMemoryError) as ei:
        torch.empty(too_many, dtype=torch.uint8, device=cuda)
    assert classify_failure(ei.value) is FailureClass.OOM
    sup = DeviceSupervisor(op_timeout_s=30.0, max_retries=2, breaker_failure_threshold=1)
    with pytest.raises(DeviceDegradedError) as ei:
        sup.call(lambda: torch.empty(too_many, dtype=torch.uint8, device=cuda), op="optimize")
    assert ei.value.failure_class is FailureClass.OOM and sup.num_retries == 0
    assert sup.breaker.state is BreakerState.OPEN
    assert torch.cuda.memory_allocated(cuda) == before


def test_failed_capture_leaves_no_graph(cuda):
    """An OOM raised inside a capture leaves none of that capture's graphs
    in the engine, releases the capture lock, and the next run captures
    anew and equals a fresh engine's run."""
    state = random_cluster(RandomClusterSpec(num_brokers=20, num_partitions=400, skew=1.0), seed=2,
                           device=cuda)
    eng = Engine(state, DEFAULT_CHAIN, config=CFG)
    real = eng._full_check
    calls = []

    def failing(ws):
        calls.append(1)
        if len(calls) == 2:  # the warm-up ran; this is the capture
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (raised inside the capture)")
        return real(ws)

    eng._full_check = failing
    with pytest.raises(torch.cuda.OutOfMemoryError):
        eng.run()
    assert not kernels._CAPTURE_LOCK.locked()
    assert set(eng._ws.graphs).isdisjoint({"init", "eval", "body"}) and not eng._ws.loops
    eng._full_check = real
    f1, h1 = eng.run()
    f2, h2 = Engine(state, DEFAULT_CHAIN, config=CFG).run()
    for f in ("replica_broker", "replica_is_leader", "replica_disk"):
        assert torch.equal(getattr(f1, f), getattr(f2, f)), f
    assert [h for h in h1 if "round" in h] == [h for h in h2 if "round" in h]


def test_supervised_optimize_degrades_and_recovers_on_card(cuda):
    """A supervised optimize on the card with an OOM injected on
    "engine.run": `DeviceDegradedError` of class OOM, never a CPU answer,
    the breaker open and the engine purged; then the probe closes it and
    the card's answer is the unsupervised run's bit for bit."""
    from cruise_control_tpu_torch.analyzer import GoalOptimizer
    from cruise_control_tpu_torch.common.device_watchdog import (
        DeviceDegradedError,
        DeviceSupervisor,
        FailureClass,
    )
    from cruise_control_tpu_torch.testing import faults

    state = fixtures.dead_broker_cluster(cuda)
    want = GoalOptimizer(config=CFG, device=cuda).optimize(state)
    sup = DeviceSupervisor(op_timeout_s=120.0, max_retries=0, breaker_failure_threshold=1,
                           probe_interval_s=0.0, device=cuda)
    opt = GoalOptimizer(config=CFG, device=cuda, supervisor=sup, degraded_budget_s=10.0)
    with faults.device_oom(schedule=faults.first(1)):
        with pytest.raises(DeviceDegradedError) as ei:
            opt.optimize(state)
    assert ei.value.failure_class is FailureClass.OOM and sup.is_degraded
    assert not opt.has_engine_for(state.shape, config=CFG)
    again = opt.optimize(state)
    assert not again.degraded and not sup.is_degraded
    for f in ("replica_broker", "replica_is_leader", "replica_disk"):
        assert torch.equal(getattr(again.state_after, f), getattr(want.state_after, f)), f
    assert len(again.proposals) == len(want.proposals)


def test_abandoned_spin_holds_the_breaker_open_on_card(cuda):
    """A call that spins the card past its budget is abandoned as a HANG;
    while its worker waits for the spin the default probe fails and the
    breaker stays open, and once the worker returns the probe closes it."""
    import time

    from cruise_control_tpu_torch.common.device_watchdog import (
        DeviceDegradedError,
        DeviceSupervisor,
        FailureClass,
    )

    sup = DeviceSupervisor(op_timeout_s=0.5, max_retries=0, breaker_failure_threshold=1,
                           probe_interval_s=0.0, device=cuda)
    cpm = _spin_cycles_per_ms(cuda)

    def spin():
        torch.cuda._sleep(int(2000 * cpm))
        torch.cuda.current_stream().synchronize()

    with pytest.raises(DeviceDegradedError) as ei:
        sup.call(spin, op="optimize")
    assert ei.value.failure_class is FailureClass.HANG
    assert not sup.available() and "abandoned" in sup.last_failure["error"]
    deadline = time.monotonic() + 30.0
    while sup.abandoned_running() and time.monotonic() < deadline:
        time.sleep(0.05)
    assert sup.available() and not sup.is_degraded


# ----------------------------------------------------------------------
# the mesh layer's lane slices and routes (parallel/mesh.py)
# ----------------------------------------------------------------------


def _slice_parts(out: dict, ln, grp: str):
    """A launch's outputs of one group split by kind (relocations, swaps,
    leadership; the relocation rows' two swap halves)."""
    a, b = ln.n_r, ln.n_r + ln.n_s
    if grp == "payl":
        return (out,)
    return out[:a], out[a:b], out[b:]


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("variant", CAND_VARIANTS)
def test_candidate_slices_match_the_full_launch_and_plain(cuda, variant, n):
    """The candidates kernel's lane slices (`Lanes.shard`, the mesh
    layer's candidate axis): the n slices' lanes, kind by kind, are the
    full-K launch bit for bit, and each slice's ids, masks, payload and
    acceptance are its plain version's slice exactly, its deltas within
    move_delta's bar, on the lanes below each kind's K."""
    eng, carry, g, keys, plan = _variant_step(cuda, variant, "random", split=PARTIAL_SPLITS["odd"]
                                              if variant != "intra" else (119, 0, 0))
    cp = eng.cand
    T = 0.01
    full = cand_k.candidates(cp, eng.statics, carry, keys, g, plan, T)
    full = {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in full.items()}
    sizes = {"out": (cp.K_r, cp.K_s, cp.K_l), "payr": (cp.K_r, cp.K_s, cp.K_s), "payl": (cp.K_l,)}
    parts = []
    for j in range(n):
        ln = cand_k.Lanes.shard(cp, j, n)
        got = cand_k.candidates(cp, eng.statics, carry, keys, g, plan, T, lanes=ln)
        got = dict(got, payr={k: v.clone() for k, v in got["payr"].items()},
                   payl={k: v.clone() for k, v in got["payl"].items()})
        want = cand_k.candidates_plain(cp, eng.statics, carry, keys, g, plan, T, lanes=ln)
        valid = [torch.arange(b, b + m, device=cuda) < k for b, m, k in
                 ((ln.base_r, ln.n_r, cp.K_r), (ln.base_s, ln.n_s, cp.K_s), (ln.base_l, ln.n_l, cp.K_l))]
        vb = torch.cat(valid)
        for f in ("feas", "accept", "src", "dst", "part1", "part2"):
            assert torch.equal(got[f][vb], want[f][vb]), (j, f)
        bar = 1e-4 * want["delta"][vb].abs() + 1e-6 * float(full["delta"].abs().max()) + 1e-12
        assert bool(((got["delta"][vb] - want["delta"][vb]).abs() <= bar).all())
        for grp, m in (("payr", torch.cat([valid[0], valid[1], valid[1]])), ("payl", valid[2])):
            for f, t in want[grp].items():
                assert torch.equal(got[grp][f][m], t[m]), (j, grp, f)
        parts.append((ln, got))
    for grp in ("out", "payr", "payl"):
        names = ("delta", "feas", "accept", "src", "dst", "part1", "part2") if grp == "out" \
            else tuple(full[grp])
        for f in names:
            segs = [_slice_parts(p[f] if grp == "out" else p[grp][f], ln, grp) for ln, p in parts]
            cat = torch.cat([torch.cat([s[k] for s in segs])[:sizes[grp][k]]
                             for k in range(len(sizes[grp]))])
            ref = full[f] if grp == "out" else full[grp][f]
            a, b = (cat.view(torch.int32), ref.view(torch.int32)) if ref.dtype == torch.float32 \
                else (cat, ref)
            assert torch.equal(a, b), (grp, f)
    if full["from_prior"] is not None:
        assert torch.equal(torch.cat([p["from_prior"] for _, p in parts])[:cp.K_r],
                           full["from_prior"])


def test_mesh_host_loop_matches_the_loop_graph(cuda):
    """The mesh layer's host-loop route (the rounds driven from the host
    over the captured graphs, where the card refuses a loop graph holding
    a collective) is the loop graph's run bit for bit: placements, ys and
    payload; 3 syncs a round and one at the end."""
    from cruise_control_tpu_torch.analyzer.options import DEFAULT_OPTIONS
    from cruise_control_tpu_torch.config.balancing import DEFAULT_CONSTRAINT
    from cruise_control_tpu_torch.parallel.mesh import RankEngine

    state = random_cluster(RandomClusterSpec(num_brokers=20, num_partitions=400, skew=1.0), seed=2,
                           device=cuda)
    plain = Engine(state, DEFAULT_CHAIN, config=CFG)
    p_final, p_hist, p_out = plain.run_reported()
    eng = RankEngine(state, DEFAULT_CHAIN, DEFAULT_CONSTRAINT, DEFAULT_OPTIONS, CFG,
                     key=Key.from_seed(CFG.seed), shard=(0, 1))
    eng.loop_route = "host"
    for _ in range(2):
        h_final, h_hist, h_out = eng._run_fused(reports=True)
        for f in ("replica_broker", "replica_is_leader", "replica_disk"):
            assert torch.equal(getattr(h_final, f), getattr(p_final, f)), f
        assert plain.last_ys.tobytes() == eng.last_ys.tobytes()
        assert [h for h in h_hist if "round" in h] == [h for h in p_hist if "round" in h]
        assert float(h_out["obj_after"]) == float(p_out["obj_after"])
        rounds = h_hist[-1]["loop_iterations"]
        assert h_hist[-1]["blocking_syncs"] == 3 * rounds + 1


def test_mesh_over_nccl_matches_the_plain_engine(cuda):
    """A 1x1 rank group over NCCL (and 1x2 where the host has two cards)
    runs the plain engine's anneal: placements and round records bit for
    bit, no gather at 1x1, one a step at 1x2, the row's carries equal."""
    from cruise_control_tpu_torch.parallel import ShardedEngine, close_rank_groups, model_mesh

    state = random_cluster(RandomClusterSpec(num_brokers=20, num_partitions=400, skew=1.0), seed=2,
                           device=cuda)
    p_final, p_hist = Engine(state, DEFAULT_CHAIN, config=CFG).run()
    widths = [1, 2] if torch.cuda.device_count() >= 2 else [1]
    try:
        for n in widths:
            se = ShardedEngine(state, DEFAULT_CHAIN, mesh=model_mesh([f"cuda:{i}" for i in range(n)]),
                               config=CFG, timeout_s=300)
            m_final, m_hist = se.run()
            for f in ("replica_broker", "replica_is_leader", "replica_disk"):
                assert torch.equal(getattr(m_final, f), getattr(p_final, f)), (n, f)
            assert [h for h in m_hist if "round" in h] == [h for h in p_hist if "round" in h]
            assert m_hist[-1]["backend"] == "nccl"
            ran = len([h for h in m_hist if "round" in h])
            assert m_hist[-1]["collectives"] == (0 if n == 1 else ran * CFG.steps_per_round)
            assert len(set(se.carry_digests())) == 1
            se.release()
    finally:
        close_rank_groups()


def _shard_setup(cuda, n: int):
    """A small cluster padded for n model shards on the card: its engine,
    first carry, plan and step keys, and the n shards' blocks, views and
    sampling plans."""
    from types import SimpleNamespace

    from cruise_control_tpu_torch.kernels import model_shard as ms_k
    from cruise_control_tpu_torch.kernels.group import group_placement
    from cruise_control_tpu_torch.models.builder import pad_state
    from cruise_control_tpu_torch.models.sharding import shard_multiple_shape
    from cruise_control_tpu_torch.parallel.model_shard import ShardPlan, shard_views

    state = random_cluster(RandomClusterSpec(num_brokers=20, num_partitions=400, skew=1.0), seed=2,
                           device=cuda)
    eng = Engine(pad_state(state, shard_multiple_shape(state.shape, n)), DEFAULT_CHAIN, config=CFG)
    carry = eng.init_carry(Key.from_seed(3))
    plan = eng.plan(carry)
    s = eng.shape
    keys = cand_k.StepKeys.of(carry.key)
    blks = [ms_k.Block.of(s.R, s.P, j, n) for j in range(n)]
    views = [shard_views(eng.statics, carry, b) for b in blks]
    groups = [group_placement(c.replica_broker, sx.state.replica_valid, s.B) for sx, c in views]
    counts = torch.stack([gp.count for gp in groups])
    plans = [ShardPlan(broker_cdf=plan.broker_cdf, order=gp.order, start=gp.start, count=plan.count,
                       count_local=gp.count, below=counts[:j].sum(0).to(torch.int32),
                       start_global=plan.start, replica_cost=plan.replica_cost,
                       lead_cost=plan.lead_cost) for j, gp in enumerate(groups)]
    return SimpleNamespace(eng=eng, carry=carry, plan=plan, keys=keys,
                           cursor=cand_k.KeyCursor.of(keys, cuda), blks=blks, views=views,
                           plans=plans, whole=ms_k.Block(0, s.R, 0, s.P, 0, 1))


@pytest.mark.parametrize("n", [2, 4])
def test_model_shard_kernels_against_the_whole_model(cuda, n):
    """The sharded-model mode's kernels (kernels/model_shard.py, the
    candidates kernel's SHARD body, apply_moves with row offsets), n shards
    emulated on one card: the assembled bundles are the whole model's
    gathers, the body the full launch bit for bit, each gather kernel its
    plain version bit for bit, each shard's offset apply its block of the
    whole apply."""
    from cruise_control_tpu_torch.kernels import model_shard as ms_k

    t = _shard_setup(cuda, n)
    eng, carry, plan, keys, cursor = t.eng, t.carry, t.plan, t.keys, t.cursor
    blks, views, plans = t.blks, t.views, t.plans
    g = eng._globals(carry)
    temp = torch.full((1,), 0.5, device=cuda)
    cp, s = eng.cand, eng.shape
    full = cand_k.candidates(cp, eng.statics, carry, cursor, g, plan, temp)

    def hop(fn, plain):
        out = None
        for j, (sx, c) in enumerate(views):
            k = fn(j, sx, c)
            assert torch.equal(k, plain(j, sx, c))
            out = k if out is None else out + k
        return out

    max_rf, pw = eng.max_rf, eng.max_rf + s.num_racks
    n_rs = cp.K_r + 2 * cp.K_s
    ids = hop(lambda j, sx, c: ms_k.shard_sources(cp, cursor, plans[j], sx.gen, blks[j], True),
              lambda j, sx, c: ms_k.shard_sources_plain(cp, keys, plans[j], sx.gen, blks[j], True))
    rows = hop(lambda j, sx, c: ms_k.own_rows(ids, ms_k.ROW_WORDS, ms_k.row_columns(sx.state, c),
                                              blks[j]),
               lambda j, sx, c: ms_k.own_rows_plain(ids, ms_k.ROW_WORDS,
                                                    ms_k.row_columns(sx.state, c), blks[j]))
    parts = hop(lambda j, sx, c: ms_k.own_parts(rows.view(-1)[1:], int(ids.shape[0]), ms_k.ROW_WORDS,
                                                sx.part_replicas, c.part_rack_count, blks[j]),
                lambda j, sx, c: ms_k.own_parts_plain(rows[:, 1], sx.part_replicas,
                                                      c.part_rack_count, blks[j]))
    mb = hop(lambda j, sx, c: ms_k.own_rows(parts, 1, ms_k.row_columns(sx.state, c), blks[j],
                                            m=max_rf, stride=pw, n=n_rs),
             lambda j, sx, c: ms_k.own_rows_plain(parts[:n_rs, :max_rf], 1,
                                                  ms_k.row_columns(sx.state, c), blks[j]))
    ml = hop(lambda j, sx, c: ms_k.own_rows(parts[n_rs:], ms_k.ROW_WORDS,
                                            ms_k.row_columns(sx.state, c), blks[j], m=max_rf,
                                            stride=pw, n=cp.K_l),
             lambda j, sx, c: ms_k.own_rows_plain(parts[n_rs:, :max_rf], ms_k.ROW_WORDS,
                                                  ms_k.row_columns(sx.state, c), blks[j]))
    sh = cand_k.ShardBundles(ids=ids, rows=rows, parts=parts, mb=mb, ml=ml, shape=s)
    before = kernels.LAUNCHES["candidates_shard"]
    body = cand_k.candidates_shard(cp, views[0][0], views[0][1], cursor, g, plans[0], temp, sh)
    assert kernels.LAUNCHES["candidates_shard"] == before + 1
    for f in ("delta", "feas", "accept", "src", "dst", "part1", "part2"):
        assert torch.equal(body[f].view(torch.int32) if f == "delta" else body[f],
                           full[f].view(torch.int32) if f == "delta" else full[f]), f
    survive, sv_r, _ = select_k.select_survivors(
        full["accept"], full["delta"], full["src"], full["dst"], full["part1"], full["part2"],
        num_brokers=s.B, num_parts=s.P, n_r=full["nr"], n_s=full["ns"])
    sv_l = survive[full["nr"] + full["ns"]:]
    whole = carry.clone()
    apply_k.apply_moves(eng.statics, whole, sv_r, full["payr"], sv_l, full["payl"])
    for b, (sx, c_j) in zip(blks, views):
        c = dataclasses.replace(carry.clone(), **{f: getattr(c_j, f).clone() for f in (
            "replica_broker", "replica_is_leader", "replica_disk", "part_rack_count")})
        apply_k.apply_moves(sx, c, sv_r, full["payr"], sv_l, full["payl"], r_off=b.r_off,
                            p_off=b.p_off)
        assert torch.equal(c.replica_broker, whole.replica_broker[b.r_off: b.r_off + b.r_local])
        assert torch.equal(c.part_rack_count, whole.part_rack_count[b.p_off: b.p_off + b.p_local])
        assert torch.equal(c.broker_load.view(torch.int32), whole.broker_load.view(torch.int32))
        prc = ms_k.shard_prc(sx.state, c_j.replica_broker, s.P)
        assert torch.equal(prc, ms_k.shard_prc_plain(sx.state, c_j.replica_broker, s.P))
    torch.cuda.synchronize()


def _hop3_bundles(t):
    """The assembled ids, rows and parts of the setup's emulated step."""
    from cruise_control_tpu_torch.kernels import model_shard as ms_k

    cp = t.eng.cand
    ids = sum(ms_k.shard_sources(cp, t.cursor, t.plans[j], sx.gen, t.blks[j], True)
              for j, (sx, _c) in enumerate(t.views))
    rows = sum(ms_k.own_rows(ids, ms_k.ROW_WORDS, ms_k.row_columns(sx.state, c), t.blks[j])
               for j, (sx, c) in enumerate(t.views))
    parts = sum(ms_k.own_parts(rows.view(-1)[1:], int(ids.shape[0]), ms_k.ROW_WORDS,
                               sx.part_replicas, c.part_rack_count, t.blks[j])
                for j, (sx, c) in enumerate(t.views))
    return ids, rows, parts


@pytest.mark.parametrize("split", ["step", "no_leadership", "leadership_only"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_own_member_rows_one_launch_equals_plain(cuda, n, split):
    """Hop 4's one launch of the own_rows kernel, on every shard: byte for
    byte its plain version and the two own_rows launches it replaces, one
    launch counted; with no leadership rows (K_l = 0) and with no
    relocation or swap rows (n_rs = 0) too."""
    from cruise_control_tpu_torch.kernels import model_shard as ms_k

    t = _shard_setup(cuda, n)
    cp, max_rf = t.eng.cand, t.eng.max_rf
    pw = max_rf + t.eng.shape.num_racks
    _, _, parts = _hop3_bundles(t)
    n_rs = dict(step=cp.K_r + 2 * cp.K_s, no_leadership=int(parts.shape[0]), leadership_only=0)[split]
    n_l = int(parts.shape[0]) - n_rs
    total = None
    for j, (sx, c) in enumerate(t.views):
        cols = ms_k.row_columns(sx.state, c)
        before = dict(kernels.LAUNCHES)
        got = ms_k.own_member_rows(parts, n_rs, max_rf, cols, t.blks[j])
        assert kernels.LAUNCHES["own_member_rows"] == before["own_member_rows"] + 1
        assert kernels.LAUNCHES["own_rows"] == before["own_rows"]
        assert torch.equal(got, ms_k.own_member_rows_plain(parts, n_rs, max_rf, cols, t.blks[j]))
        two = [ms_k.own_rows(parts, 1, cols, t.blks[j], m=max_rf, stride=pw, n=n_rs),
               ms_k.own_rows(parts[n_rs:], ms_k.ROW_WORDS, cols, t.blks[j], m=max_rf, stride=pw,
                             n=n_l)]
        assert torch.equal(got, torch.cat([x.reshape(-1) for x in two]))
        total = got if total is None else total + got
    whole = ms_k.own_member_rows_plain(parts, n_rs, max_rf,
                                       ms_k.row_columns(t.eng.statics.state, t.carry), t.whole)
    assert torch.equal(total, whole)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", [1, 2, 4])
def test_own_rows_at_a_shards_first_and_last_rows(cuda, n):
    """Ids at every shard's first and last rows, just past them, the
    member table's padding R and -1: hop 2's rows and hop 4's bundle are
    their plain versions byte for byte on every shard, and sum to the
    whole model's rows."""
    from cruise_control_tpu_torch.kernels import model_shard as ms_k

    t = _shard_setup(cuda, n)
    R, max_rf = t.eng.shape.R, t.eng.max_rf
    edges = sorted({v for b in t.blks for v in (b.r_off - 1, b.r_off, b.r_off + b.r_local - 1,
                                                b.r_off + b.r_local)} | {-1, 0, R - 1, R})
    ids = torch.tensor(edges, dtype=torch.int32, device=cuda)
    # a hop-3 bundle of k rows whose member ids run through the edges
    k = 2 * -(-len(edges) // max_rf)
    member_ids = ids.repeat(-(-k * max_rf // len(edges)))[: k * max_rf].view(k, max_rf)
    parts = torch.cat([member_ids, torch.full((k, 3), 99, dtype=torch.int32, device=cuda)],
                      1).contiguous()
    whole_cols = ms_k.row_columns(t.eng.statics.state, t.carry)
    rows_sum, mrows_sum = None, None
    for j, (sx, c) in enumerate(t.views):
        cols = ms_k.row_columns(sx.state, c)
        rows = ms_k.own_rows(ids, ms_k.ROW_WORDS, cols, t.blks[j])
        assert torch.equal(rows, ms_k.own_rows_plain(ids, ms_k.ROW_WORDS, cols, t.blks[j]))
        mrows = ms_k.own_member_rows(parts, k // 2, max_rf, cols, t.blks[j])
        assert torch.equal(mrows, ms_k.own_member_rows_plain(parts, k // 2, max_rf, cols, t.blks[j]))
        rows_sum = rows if rows_sum is None else rows_sum + rows
        mrows_sum = mrows if mrows_sum is None else mrows_sum + mrows
    assert torch.equal(rows_sum, ms_k.own_rows_plain(ids, ms_k.ROW_WORDS, whole_cols, t.whole))
    assert torch.equal(mrows_sum, ms_k.own_member_rows_plain(parts, k // 2, max_rf, whole_cols,
                                                             t.whole))
    torch.cuda.synchronize()


@pytest.mark.parametrize("case", ["plan", "empty_brokers", "global_cdf"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_shard_sources_against_plain(cuda, n, case, monkeypatch):
    """shard_sources byte for byte its plain version on every shard: with
    the step's plan (the CDF staged in shared memory; the shards' ids sum
    to the full launch's sources), with half the brokers' counts zeroed
    (importance draws that take the fallback), and with a CDF past the
    shared-memory budget (probed from global memory)."""
    from cruise_control_tpu_torch.kernels import model_shard as ms_k

    t = _shard_setup(cuda, n)
    cp, B = t.eng.cand, t.eng.shape.B
    plans = t.plans
    if case == "empty_brokers":
        count = t.plan.count.clone()
        count[::2] = 0
        plans = [dataclasses.replace(sp, count=count) for sp in plans]
        bsel, _, _ = ms_k.importance_draws(t.keys.rel_src, cp.K_r, cp.n_imp(cp.K_r, plans[0]),
                                           t.plan.broker_cdf, count, t.views[0][0].gen, cuda)
        assert bool((count[bsel] <= 0).any()) and bool((count[bsel] > 0).any())
    if case == "global_cdf":
        monkeypatch.setattr(ms_k, "SOURCES_CDF_SMEM_MAX", 4 * B - 4)
    total = None
    for j, (sx, _c) in enumerate(t.views):
        before = kernels.LAUNCHES["shard_sources"]
        got = ms_k.shard_sources(cp, t.cursor, plans[j], sx.gen, t.blks[j], True)
        assert kernels.LAUNCHES["shard_sources"] == before + 1
        assert torch.equal(got, ms_k.shard_sources_plain(cp, t.keys, plans[j], sx.gen, t.blks[j], True))
        total = got if total is None else total + got
    if case != "empty_brokers":
        full = cand_k.candidates(cp, t.eng.statics, t.carry, t.cursor, t.eng._globals(t.carry),
                                 t.plan, torch.full((1,), 0.5, device=cuda))
        assert torch.equal(total, torch.cat([full["payr"]["r"], full["payl"]["rt"]]).to(torch.int32))
    torch.cuda.synchronize()
