"""The port's self-healing runtime (``repro_torch.resilience``) on the CPU.

One port test for each test of ``tests/test_resilience.py``, on the
port's containers: the guard and fault units, the torn ``leaves.bin``
refused and skipped, the serving hardening, the chaos matrix in the three
topologies with the reference's expected fault sets, and abort, retry and
rollback -- retry and rollback each held bit for bit to the port's own
clean run (JAX's threefry stream is not the port's, so those are not
compared with JAX).  Then the parity cases with the JAX package: plan
parsing, the backoff's jitter, ``bitflip_tree`` on int8 and int4 caches
packed in both packages from the same numpy params (the same bytes
flipped), ``poison_params`` (the same element) and ``validate_cache`` on
the reference's corruptions (the same error types).
"""
import dataclasses
import os
import time

import jax
import numpy as np
import pytest
import torch

from repro.resilience import faults as jfaults
from repro.resilience import guards as jguards
from repro.rl import actorq as jactorq
from repro.rl.networks import make_network as jmake_network
from repro_torch import resilience as rz
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.ckpt import DATA_FILE
from repro_torch.core.ptq import PackedTensor, tree_flatten, tree_map
from repro_torch.resilience import faults, guards, supervisor
from repro_torch.rl import actorq, loops, networks
from repro_torch.rl.env import EnvSpec

SMALL = dict(n_envs=2, rollout_steps=2, updates_per_iter=2,
             buffer_size=64, batch_size=8, warmup=8)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these nets are small, and the suite's workers
    share the machine's cores (bitwise comparisons stay inside a test)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _leaves(result):
    return tree_flatten(result.state.params)[1]


def _assert_same_params(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)


def _kwargs(topo, *, iterations=6, ckpt_dir=None, ckpt_every=3, **kw):
    """``tests/test_resilience.py``'s ``_kwargs`` on the CPU."""
    multi = topo != "fused"
    out = dict(algo="dqn", env_name="cartpole", iterations=iterations,
               seed=3, record_every=3, eval_episodes=2,
               actor_backend="int8", algo_overrides=dict(SMALL),
               net_kwargs=dict(hidden=(16,)), topology=topo,
               num_actors=2 if multi else 1,
               sync_every=2 if multi else 1,
               checkpoint_dir=ckpt_dir,
               checkpoint_every=ckpt_every if ckpt_dir else 0,
               device="cpu")
    out.update(kw)
    return out


def _jparams(hidden=(8,), seed=0):
    return jmake_network((4,), 2, hidden=hidden).init(
        jax.random.PRNGKey(seed))


def _tparams(jparams):
    return networks.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _mlp_cache(backend="int8"):
    params = _tparams(_jparams())
    return params, actorq.make_actor_cache(params, backend)


def _map_packed(fn, cache):
    return tree_map(lambda x: fn(x) if isinstance(x, PackedTensor) else x,
                    cache)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_crc_detects_single_bitflip():
    _, cache = _mlp_cache()
    crc = guards.tree_crc32(cache)
    flipped = faults.bitflip_tree(cache, seed=7, nbits=1)
    assert guards.tree_crc32(flipped) != crc
    assert guards.tree_crc32(cache) == crc          # the input is untouched
    guards.verify_crc(cache, crc, what="cache")
    with pytest.raises(guards.IntegrityError, match="checksum mismatch"):
        guards.verify_crc(flipped, crc, what="cache")


def test_crc_covers_dtype_and_shape():
    a = {"x": torch.zeros(4, dtype=torch.float32)}
    b = {"x": torch.zeros(4, dtype=torch.int32)}  # same bytes, other dtype
    c = {"x": torch.zeros((2, 2), dtype=torch.float32)}
    assert len({guards.tree_crc32(t) for t in (a, b, c)}) == 3


def test_check_finite_names_offending_leaf():
    tree = {"w": torch.ones(3), "b": torch.tensor([1.0, float("nan")])}
    with pytest.raises(guards.NonFiniteError, match=r"\['b'\]"):
        guards.check_finite(tree, what="params")
    guards.check_finite({"w": torch.ones(3)})
    # int leaves are not finite-checked
    guards.check_finite({"codes": torch.tensor([1, 2], dtype=torch.int8)})


def test_all_finite_is_one_device_reduction():
    """The port's counterpart of the jit case: ``all_finite`` is a 0-d
    bool tensor on the leaves' device (no host read), one reduction over
    every float leaf, integer leaves skipped."""
    tree = {"w": torch.ones(3), "n": {"b": torch.zeros(2, 2)},
            "codes": torch.tensor([127], dtype=torch.int8)}
    ok = guards.all_finite(tree)
    assert isinstance(ok, torch.Tensor) and ok.dim() == 0
    assert ok.dtype == torch.bool and bool(ok)
    tree["n"]["b"] = torch.tensor([[1.0, float("inf")], [0.0, 0.0]])
    assert not bool(guards.all_finite(tree))
    assert bool(guards.all_finite({"codes": tree["codes"]}))


def test_validate_cache_catches_scale_corruption():
    _, cache = _mlp_cache()
    guards.validate_cache(cache)
    bad = _map_packed(lambda x: dataclasses.replace(
        x, delta=torch.full_like(x.delta, float("nan"))), cache)
    with pytest.raises(guards.CodeRangeError, match="delta"):
        guards.validate_cache(bad)


def test_validate_cache_catches_packed_size_mismatch():
    _, cache = _mlp_cache("int4")
    guards.validate_cache(cache)
    bad = _map_packed(lambda x: dataclasses.replace(
        x, codes=x.codes.reshape(-1)[:-1]) if x.orig_shape is not None
        else x, cache)
    with pytest.raises(guards.CodeRangeError, match="packed"):
        guards.validate_cache(bad)


def test_backoff_deterministic_and_capped():
    a = guards.backoff_delay(2, base_s=0.01, factor=2.0, cap_s=1.0, seed=7)
    b = guards.backoff_delay(2, base_s=0.01, factor=2.0, cap_s=1.0, seed=7)
    assert a == b
    assert a >= 0.04                        # base * factor**2, plus jitter
    assert guards.backoff_delay(50, base_s=0.01, factor=2.0, cap_s=0.3,
                                seed=7) == 0.3
    assert guards.deterministic_jitter(1, 2) != \
        guards.deterministic_jitter(1, 3)


def test_retry_call_bounded():
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise guards.IntegrityError("transient")
        return "ok"

    out = guards.retry_call(flaky, retries=2, base_s=0.01, factor=2.0,
                            cap_s=0.1, retry_on=guards.GuardError,
                            sleep=slept.append)
    assert out == "ok" and len(calls) == 3 and len(slept) == 2

    calls.clear()

    def always():
        calls.append(1)
        raise guards.IntegrityError("always")

    with pytest.raises(guards.IntegrityError):
        guards.retry_call(always, retries=1, base_s=0.01, factor=2.0,
                          cap_s=0.1, retry_on=guards.GuardError,
                          sleep=lambda s: None)
    assert len(calls) == 2                  # 1 + retries


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------

def test_fault_plan_parse_roundtrip():
    spec = "7:nan_grad@3,bitflip_push@5:nbits=3,actor_crash@8:shard=1"
    plan = faults.FaultPlan.parse(spec)
    assert plan.seed == 7 and len(plan.faults) == 3
    assert plan.faults[1].nbits == 3 and plan.faults[2].shard == 1
    assert faults.FaultPlan.parse(plan.spec_string()) == plan
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.FaultPlan.parse("1:meteor@3")
    with pytest.raises(ValueError, match="SEED"):
        faults.FaultPlan.parse("nan_grad@3")
    with pytest.raises(ValueError, match="nan|inf"):
        faults.FaultSpec(kind="nan_grad", step=1, mode="zero")


def test_bitflip_tree_deterministic_and_minimal():
    _, cache = _mlp_cache()
    a = faults.bitflip_tree(cache, seed=11, nbits=2)
    b = faults.bitflip_tree(cache, seed=11, nbits=2)
    assert guards.tree_crc32(a) == guards.tree_crc32(b)
    assert guards.tree_crc32(a) != guards.tree_crc32(cache)
    # structure, dtypes and shapes survive the corruption
    pa, la = tree_flatten(a)
    pc, lc = tree_flatten(cache)
    assert pa == pc
    assert [(x.dtype, x.shape) for x in la] == \
        [(x.dtype, x.shape) for x in lc]
    # at most nbits bytes differ across the flattened payload
    diff = sum(int(np.sum(x.numpy().reshape(-1).view(np.uint8)
                          != y.numpy().reshape(-1).view(np.uint8)))
               for x, y in zip(la, lc))
    assert 1 <= diff <= 2


def test_poison_params_modes():
    params = {"w": torch.ones((2, 2)), "codes": torch.ones(4,
                                                           dtype=torch.int8)}
    nan = faults.poison_params(params, "nan")
    assert torch.isnan(nan["w"].reshape(-1)[0])
    assert torch.isinf(faults.poison_params(params, "inf")["w"].reshape(-1)[0])
    # out of place: the input keeps its values; int leaves never poisoned
    assert torch.equal(params["w"], torch.ones((2, 2)))
    assert nan["codes"] is params["codes"]


def test_injector_fires_once_across_attempts():
    inj = faults.FaultInjector(faults.FaultPlan.parse("3:nan_grad@4"))
    assert inj.pending("nan_grad", 3) is None
    # chunked drivers overshoot the target round: first opportunity wins
    assert inj.take("nan_grad", 6) is not None
    assert inj.take("nan_grad", 6) is None   # consumed; never re-fires
    inj.record_fired("nan_grad", 6)
    assert inj.injected_count == 1


def test_injector_repeat_budget():
    inj = faults.FaultInjector(
        faults.FaultPlan.parse("3:straggler@2:repeat=2"))
    assert inj.take("straggler", 2) is not None
    assert inj.take("straggler", 3) is not None
    assert inj.take("straggler", 4) is None


def test_watchdog_stall_episodes():
    t = [0.0]
    wd = supervisor.Watchdog(timeout_s=1.0, clock=lambda: t[0])
    wd.beat("round", 1)
    t[0] = 2.5
    wd.check()
    wd.check()                  # same episode: recorded once
    assert len(wd.stalls) == 1 and wd.stalls[0]["phase"] == "round"
    wd.beat("push", 2)          # re-arms
    t[0] = 5.0
    wd.check()
    assert len(wd.stalls) == 2 and wd.stalls[1]["phase"] == "push"


# ---------------------------------------------------------------------------
# checkpoint integrity: a torn leaves.bin
# ---------------------------------------------------------------------------

def test_torn_checkpoint_rejected_and_skipped(tmp_path):
    d = str(tmp_path)
    loops.train(**_kwargs("fused", ckpt_dir=d, ckpt_every=3))
    mgr = CheckpointManager(d)
    assert mgr.steps() == [3, 6]
    faults.truncate_file(os.path.join(mgr.step_path(6), DATA_FILE))
    assert not mgr.step_valid(6)
    assert mgr.step_valid(3)
    assert mgr.latest_step() == 3           # the torn step is skipped
    with pytest.raises(ValueError, match="checksum mismatch"):
        mgr.restore(6, _template_of(mgr, 6))
    mgr.restore(3, _template_of(mgr, 3))    # the valid one still loads


def _template_of(mgr, step):
    """A flat template of ``step``'s leaves, from its manifest."""
    from repro_torch.checkpoint.ckpt import _TORCH
    return [torch.zeros(tuple(s["shape"]), dtype=_TORCH[s["dtype"]])
            for s in mgr.manifest(step)["leaves"]]


def test_resume_skips_torn_newest_checkpoint(tmp_path):
    d = str(tmp_path)
    ref = loops.train(**_kwargs("fused", iterations=9))
    loops.train(**_kwargs("fused", iterations=6, ckpt_dir=d, ckpt_every=3))
    mgr = CheckpointManager(d)
    faults.truncate_file(os.path.join(mgr.step_path(6), DATA_FILE))
    res = loops.train(**_kwargs("fused", iterations=9, ckpt_dir=d,
                                ckpt_every=3, resume=True))
    # resumed from step 3 (the newest valid step) and still bitwise on
    # the run that never stopped
    _assert_same_params(ref, res)
    assert ref.rewards == res.rewards


# ---------------------------------------------------------------------------
# serving hardening
# ---------------------------------------------------------------------------

def _serve_setup(**srv_kw):
    from repro_torch.serving import PolicyServer

    spec = EnvSpec(name="resilience-test", obs_shape=(4,), n_actions=2)
    params = _tparams(_jparams())
    srv = PolicyServer(spec, actor_backend="int8", buckets=(4, 8),
                       max_wait_us=200, device="cpu", **srv_kw)
    srv.push_params(params)
    return srv, params


def test_bounded_queue_sheds_with_typed_error():
    from repro_torch.serving import QueueFullError

    srv, _ = _serve_setup(max_queue=2)
    obs = np.zeros(4, np.float32)
    sid = srv.open_session()
    srv.submit(sid, obs), srv.submit(sid, obs)   # fill the bound
    with pytest.raises(QueueFullError, match="admission queue full"):
        srv.submit(sid, obs)
    assert srv.stats()["rejected"] == 1
    # draining the queue re-opens admission
    srv.serve_batch(srv.batcher.get_batch(timeout=1.0))
    srv.submit(sid, obs)


def test_request_deadline_expires_with_typed_error():
    from repro_torch.serving import DeadlineExceededError

    srv, _ = _serve_setup(request_deadline_s=0.005)
    sid = srv.open_session()
    r = srv.submit(sid, np.zeros(4, np.float32))
    time.sleep(0.02)                        # worker not running: it waits
    srv.serve_batch(srv.batcher.get_batch(timeout=1.0))
    with pytest.raises(DeadlineExceededError):
        r.result(timeout=1.0)
    assert srv.stats()["deadline_expired"] == 1
    assert srv.stats()["served"] == 0


def test_worker_crash_restarts_and_counts():
    plan = faults.FaultPlan.parse("5:actor_crash@1")
    ctx = faults.ResilienceContext(faults.FaultInjector(plan))
    srv, _ = _serve_setup(fault_hook=ctx.serving_fault_hook())
    obs = np.zeros(4, np.float32)
    sid = srv.open_session()
    with srv:
        assert srv.submit(sid, obs).result(timeout=30) is not None
        # the second dispatched batch crashes the worker; it restarts
        crashed = srv.submit(sid, obs)
        with pytest.raises(faults.ActorCrashError):
            crashed.result(timeout=30)
        assert srv.submit(sid, obs).result(timeout=30) is not None
    stats = srv.stats()
    assert stats["worker"]["crashes"] >= 1
    assert stats["worker"]["restarts"] >= 1
    assert stats["last_error"] and "ActorCrashError" in stats["last_error"]
    assert stats["worker"]["wedged"] == 0


def test_hot_swap_integrity_verified():
    srv, _ = _serve_setup()
    entry = srv.current
    assert entry.crc32 == guards.tree_crc32(entry.cache)
    srv.verify_current()
    srv._entry = dataclasses.replace(
        entry, cache=faults.bitflip_tree(entry.cache, seed=3))
    with pytest.raises(guards.IntegrityError, match="checksum"):
        srv.verify_current()


# ---------------------------------------------------------------------------
# the chaos matrix: every fault kind, all three topologies
# ---------------------------------------------------------------------------

# the reference's MATRIX (tests/test_resilience.py): per topology a plan
# covering every kind that can fire there, plus dropped_sync everywhere
# (recorded not applicable where the push is inside the iteration)
MATRIX = (
    ("fused",
     "5:actor_crash@2,straggler@3:delay_s=0.01,nan_grad@4,"
     "bitflip_push@4,crash_commit@3,dropped_sync@2",
     {"actor_crash", "straggler", "nan_grad", "bitflip_push",
      "crash_commit"}, {"dropped_sync"}),
    ("actor-learner",
     "7:actor_crash@2,straggler@3:delay_s=0.01,nan_grad@5:mode=inf,"
     "bitflip_push@4,crash_commit@3,dropped_sync@2",
     {"actor_crash", "straggler", "nan_grad", "bitflip_push",
      "crash_commit"}, {"dropped_sync"}),
    ("async",
     "9:actor_crash@2,straggler@3:delay_s=0.01,nan_grad@5,"
     "bitflip_push@4,crash_commit@3,dropped_sync@6",
     {"actor_crash", "straggler", "nan_grad", "bitflip_push",
      "crash_commit", "dropped_sync"}, set()),
)


@pytest.mark.parametrize("topo,spec,expect_fired,expect_na", MATRIX,
                         ids=[m[0] for m in MATRIX])
def test_chaos_matrix_recovers(tmp_path, topo, spec, expect_fired,
                               expect_na):
    plan = rz.FaultPlan.parse(spec)
    kw = _kwargs(topo, iterations=8, ckpt_dir=str(tmp_path), ckpt_every=2)
    res, rep = rz.supervise(kw, plan=plan,
                            config=rz.SupervisorConfig(max_retries=4))
    assert rep.status == "ok"
    assert {k for k, _, _ in rep.faults_fired} == expect_fired
    assert {k for k, _, _ in rep.faults_not_applicable} == expect_na
    assert len(rep.faults_fired) + len(rep.faults_not_applicable) \
        == len(plan.faults)
    assert rep.retries >= 1                 # at least the actor_crash
    assert rep.quarantined == [0]
    assert all(np.isfinite(r) for r in res.rewards)


def test_supervisor_abort_carries_report(tmp_path):
    # a fault that fires on every attempt exhausts the ladder
    plan = rz.FaultPlan.parse("3:actor_crash@2:repeat=99")
    kw = _kwargs("fused", iterations=4, ckpt_dir=str(tmp_path),
                 ckpt_every=2)
    cfg = rz.SupervisorConfig(max_retries=1, max_rollbacks=1,
                              backoff_base_s=0.001, backoff_cap_s=0.002)
    with pytest.raises(rz.SupervisorAbort) as ei:
        rz.supervise(kw, plan=plan, config=cfg)
    rep = ei.value.report
    assert rep.status == "aborted"
    # initial + retry, then the rollback resets the retry budget:
    # initial from the rolled-back step + retry again = 4 attempts
    assert rep.attempts == 4
    assert rep.retries == 2 and rep.rollbacks == 1
    assert rep.attempt_log[-1]["action"] == "abort"
    assert "ActorCrashError" in rep.error
    assert "aborted" in rep.summary()
    assert rep.to_dict()["retries"] == 2


def test_unrecoverable_errors_raise_through():
    def broken(**kw):
        raise TypeError("a programming error, not a fault")

    with pytest.raises(TypeError):
        rz.supervise(dict(algo="dqn", env_name="cartpole"),
                     train_fn=broken)


# ---------------------------------------------------------------------------
# recovery is bitwise-invisible (against the port's own clean run)
# ---------------------------------------------------------------------------

def test_retry_recovery_bitwise_identical(tmp_path):
    """A retried run lands bitwise on the clean trajectory (fused)."""
    ref = loops.train(**_kwargs("fused", iterations=6))
    res, rep = rz.supervise(
        _kwargs("fused", iterations=6, ckpt_dir=str(tmp_path),
                ckpt_every=3), plan=rz.FaultPlan.parse("5:nan_grad@4"))
    assert rep.retries == 1 and rep.rollbacks == 0
    _assert_same_params(ref, res)
    assert ref.rewards == res.rewards


def test_rollback_recovery_bitwise_identical(tmp_path):
    """Poison saved into a checkpoint forces a rollback; the re-run from
    the step before lands bitwise on the clean trajectory.  As in the
    reference, ``check_every=2`` lets the poison of round 3 be committed
    at step 3, so every resume from it trips the guard at round 4 and only
    dropping step 3 recovers."""
    ref = loops.train(**_kwargs("actor-learner", iterations=6,
                                record_every=6))
    cfg = rz.SupervisorConfig(max_retries=1, max_rollbacks=1,
                              backoff_base_s=0.001, backoff_cap_s=0.002)
    res, rep = rz.supervise(
        _kwargs("actor-learner", iterations=6, record_every=6,
                ckpt_dir=str(tmp_path), ckpt_every=1),
        plan=rz.FaultPlan.parse("5:nan_grad@3"),
        guard=rz.GuardConfig(check_every=2), config=cfg)
    assert rep.rollbacks == 1
    _assert_same_params(ref, res)
    assert ref.rewards == res.rewards


@pytest.mark.slow
def test_supervised_run_still_converges(tmp_path):
    """The reference's convergence case: DQN on CartPole at the default
    MLP, actor-learner with 2 actors, 60 iterations, four faults; the
    supervised run ends bitwise on the clean one."""
    plan = rz.FaultPlan.parse(
        "11:actor_crash@5,nan_grad@10,bitflip_push@15,crash_commit@12")
    kw = dict(algo="dqn", env_name="cartpole", iterations=60, seed=0,
              record_every=20, eval_episodes=4, actor_backend="int8",
              topology="actor-learner", num_actors=2, sync_every=2,
              checkpoint_dir=str(tmp_path), checkpoint_every=5,
              device="cpu")
    ref = loops.train(**{k: v for k, v in kw.items()
                         if not k.startswith("checkpoint")})
    res, rep = rz.supervise(kw, plan=plan)
    assert rep.status == "ok" and len(rep.faults_fired) == 4
    _assert_same_params(ref, res)
    assert res.rewards[-1] == ref.rewards[-1]


def test_guarded_clean_run_is_the_bare_run():
    """A context with every guard on and no fault changes nothing: the
    hooks run between chunks, in each topology."""
    for topo in ("fused", "actor-learner", "async"):
        bare = loops.train(**_kwargs(topo, iterations=4))
        ctx = rz.ResilienceContext()
        guarded = loops.train(**_kwargs(topo, iterations=4), resilience=ctx)
        _assert_same_params(bare, guarded)
        assert bare.rewards == guarded.rewards
        assert ctx.events == [] and ctx.quarantined == []


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

PLANS = ("7:nan_grad@3,bitflip_push@5:nbits=3,actor_crash@8:shard=1",
         "3:straggler@2:repeat=2",
         "11:actor_crash@5,nan_grad@10,bitflip_push@15,crash_commit@12",
         "9:straggler@3:delay_s=0.01,nan_grad@5:mode=inf,dropped_sync@6",
         "1:")


@pytest.mark.parametrize("spec", PLANS + tuple(m[1] for m in MATRIX))
def test_plan_parse_and_spec_string_match_jax(spec):
    ours, ref = faults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    assert ours.seed == ref.seed
    assert [dataclasses.asdict(f) for f in ours.faults] == \
        [dataclasses.asdict(f) for f in ref.faults]
    assert ours.spec_string() == ref.spec_string()


def test_jitter_and_backoff_match_jax():
    for seed in (0, 1, 7, -3, 2 ** 40):
        for attempt in range(6):
            assert guards.deterministic_jitter(seed, attempt) == \
                jguards.deterministic_jitter(seed, attempt)
            kw = dict(base_s=0.01, factor=2.0, cap_s=0.5, seed=seed)
            assert guards.backoff_delay(attempt, **kw) == \
                jguards.backoff_delay(attempt, **kw)


def _both_caches(backend):
    jparams = _jparams(hidden=(16, 8), seed=2)
    return (jactorq.make_actor_cache(jparams, backend),
            actorq.make_actor_cache(_tparams(jparams), backend))


def _host_leaves_jax(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _host_leaves_port(tree):
    return [x.numpy() for x in tree_flatten(tree)[1]]


@pytest.mark.parametrize("backend", ["int8", "int4"])
@pytest.mark.parametrize("seed,nbits", [(3, 1), (11, 2), (19, 5)])
def test_bitflip_tree_flips_the_same_bytes_as_jax(backend, seed, nbits):
    jcache, tcache = _both_caches(backend)
    jl, tl = _host_leaves_jax(jcache), _host_leaves_port(tcache)
    # the two packages pack the same bytes in the same flatten order
    assert [(x.dtype, x.shape) for x in jl] == \
        [(x.dtype, x.shape) for x in tl]
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(a, b)
    jf = _host_leaves_jax(jfaults.bitflip_tree(jcache, seed, nbits))
    tf = _host_leaves_port(faults.bitflip_tree(tcache, seed, nbits))
    changed = 0
    for a, b, orig in zip(jf, tf, tl):
        assert a.tobytes() == b.tobytes()
        changed += int(np.sum(b.reshape(-1).view(np.uint8)
                              != orig.reshape(-1).view(np.uint8)))
    assert changed >= 1


@pytest.mark.parametrize("mode", ["nan", "inf"])
def test_poison_params_poisons_the_same_element_as_jax(mode):
    jparams = _jparams(hidden=(16, 8), seed=4)
    jl = _host_leaves_jax(jfaults.poison_params(jparams, mode))
    tl = _host_leaves_port(faults.poison_params(_tparams(jparams), mode))
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(a, b)   # NaN == NaN for this check
    assert sum(int((~np.isfinite(b)).sum()) for b in tl) == 1


def _jreplace(cache, fn):
    return jax.tree_util.tree_map(
        lambda x: fn(x) if isinstance(x, jguards.PackedTensor) else x,
        cache, is_leaf=lambda x: isinstance(x, jguards.PackedTensor))


CORRUPTIONS = {
    "nan delta": (lambda x: x._replace(delta=np.full_like(
        np.asarray(x.delta), np.nan)),
        lambda x: dataclasses.replace(
            x, delta=torch.full_like(x.delta, float("nan")))),
    "zero delta": (lambda x: x._replace(delta=np.zeros_like(
        np.asarray(x.delta))),
        lambda x: dataclasses.replace(x, delta=torch.zeros_like(x.delta))),
    "inf col_scale": (lambda x: x._replace(col_scale=np.full_like(
        np.asarray(x.col_scale), np.inf)),
        lambda x: dataclasses.replace(
            x, col_scale=torch.full_like(x.col_scale, float("inf")))),
    "bad bits": (lambda x: x._replace(bits=17),
                 lambda x: dataclasses.replace(x, bits=17)),
}


@pytest.mark.parametrize("backend", ["int8", "int4"])
@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_validate_cache_catches_the_references_corruptions(backend, name):
    jcache, tcache = _both_caches(backend)
    jfix, tfix = CORRUPTIONS[name]
    errors = []
    for validate, bad in ((jguards.validate_cache, _jreplace(jcache, jfix)),
                          (guards.validate_cache,
                           _map_packed(tfix, tcache))):
        with pytest.raises(Exception) as ei:
            validate(bad)
        errors.append(type(ei.value).__name__)
    assert errors == ["CodeRangeError", "CodeRangeError"]


def test_bitflip_caught_by_crc_in_both_packages():
    """The same flipped bit fails ``verify_crc`` in both packages with
    ``IntegrityError``."""
    jcache, tcache = _both_caches("int8")
    jbad = jfaults.bitflip_tree(jcache, 3, 1)
    tbad = faults.bitflip_tree(tcache, 3, 1)
    names = []
    for g, bad, good in ((jguards, jbad, jcache), (guards, tbad, tcache)):
        with pytest.raises(g.IntegrityError) as ei:
            g.verify_crc(bad, g.tree_crc32(good), what="push")
        names.append(type(ei.value).__name__)
    assert names == ["IntegrityError", "IntegrityError"]
