"""Port parity: ``repro_torch.serving.PolicyServer`` on the CPU.

* Batched == sequential, bitwise: a calibrated cache makes each row's
  compute independent of the batch it rides in, so one padded batch gives
  the actions of one-at-a-time serving.
* Hot-swap: every answer carries the version that computed it, and the
  version moves by one per push.
* A calibrated push selects the fused cache; an uncalibrated one the
  per-layer path.
* The port's server answers with the JAX server's actions on the same
  params (``params_from_jax``) and observations.
"""
import jax
import numpy as np
import pytest
import torch

from repro.rl.env import EnvSpec as JEnvSpec
from repro.rl.networks import make_network
from repro.serving import PolicyServer as JPolicyServer
from repro_torch.core import ptq
from repro_torch.resilience import guards
from repro_torch.rl import actorq, networks
from repro_torch.rl.env import EnvSpec
from repro_torch.rl.envs import make
from repro_torch.serving import PolicyServer, greedy_calib_obs

SPEC = EnvSpec("srv", obs_shape=(5,), n_actions=3)
ALL_BACKENDS = ["fp32", "int8", "int4"]


def _jparams(seed=0, hidden=(16, 16)):
    return make_network((5,), 3, hidden=hidden).init(
        jax.random.PRNGKey(seed))


def _params(seed=0):
    return networks.params_from_jax(
        jax.tree_util.tree_map(np.asarray, _jparams(seed)), device="cpu")


def _obs(n, seed=1):
    return (np.random.default_rng(seed).normal(size=(n, 5)) * 1.5
            ).astype(np.float32)


def _server(backend, *, buckets=(8,), calib=True, seed=0):
    srv = PolicyServer(SPEC, actor_backend=backend, buckets=buckets,
                       max_wait_us=0, calib_batch=32 if calib else 0,
                       device="cpu")
    srv.push_params(_params(seed), calib_obs=_obs(32, seed + 100))
    return srv


@pytest.mark.parametrize("backend", ALL_BACKENDS)
def test_batched_equals_sequential_bitwise(backend):
    srv = _server(backend)
    obs = _obs(7)
    sids = [srv.open_session() for _ in range(7)]
    batched = srv.serve(list(zip(sids, obs)))
    single = [srv.serve([(sid, o)])[0] for sid, o in zip(sids, obs)]
    np.testing.assert_array_equal(np.stack(batched), np.stack(single))
    assert srv.stats()["padding_rows"] == 1 + 7 * 7


def test_dynamic_path_padding_neutral():
    """Repeat-last-row padding never moves a per-tensor range, so the
    uncalibrated path answers the same padded as unpadded."""
    srv = _server("int8", buckets=(4, 16), calib=False)
    obs = _obs(3)
    sids = [srv.open_session() for _ in range(3)]
    got = np.stack(srv.serve(list(zip(sids, obs))))
    cache = srv.current.cache
    want = actorq.make_act_fn(SPEC)(cache, torch.from_numpy(obs)).numpy()
    np.testing.assert_array_equal(got, want)


def test_calibrated_push_selects_fused_cache():
    fused = _server("int4", calib=True).current
    per_layer = _server("int4", calib=False).current
    assert actorq.ACT_QUANT in fused.cache
    assert actorq.ACT_QUANT not in per_layer.cache
    # the static params are two f32 scalars per layer
    assert fused.nbytes == per_layer.nbytes + 8 * len(
        fused.cache[actorq.ACT_QUANT])
    # a later push without observations reuses the last calibration batch
    srv = _server("int8", calib=True)
    assert actorq.ACT_QUANT in srv.push_params(_params(5)).cache


@pytest.mark.parametrize("backend", ["int8", "int4"])
def test_hot_swap_versions(backend):
    srv = _server(backend)
    sid = srv.open_session()
    o = _obs(1)[0]
    assert srv.current.version == 0
    r0 = srv.submit(sid, o)
    srv.serve_batch(srv.batcher.get_batch(timeout=0))
    e1 = srv.push_params(_params(9))
    assert e1.version == 1 and srv.current is e1
    r1 = srv.submit(sid, o)
    srv.serve_batch(srv.batcher.get_batch(timeout=0))
    assert (r0.result(0).version, r1.result(0).version) == (0, 1)
    act = actorq.make_act_fn(SPEC)
    x = torch.from_numpy(o[None])
    assert r1.result(0).action == act(e1.cache, x).numpy()[0]
    assert srv.verify_current() is e1
    assert srv.sessions.checkout(sid).last_version == 1


@pytest.mark.parametrize("backend,calib", [
    ("fp32", False), ("int8", False), ("int8", True), ("int4", False),
    ("int4", True)])
def test_actions_equal_jax_server(backend, calib):
    jspec = JEnvSpec("srv", obs_shape=(5,), n_actions=3)
    jsrv = JPolicyServer(jspec, actor_backend=backend, kernel_backend="ref",
                         buckets=(8, 32), max_wait_us=0,
                         calib_batch=32 if calib else 0)
    jsrv.push_params(_jparams(3), calib_obs=_obs(32, 4))
    tsrv = PolicyServer(SPEC, actor_backend=backend, buckets=(8, 32),
                        max_wait_us=0, calib_batch=32 if calib else 0,
                        device="cpu")
    tsrv.push_params(_params(3), calib_obs=_obs(32, 4))
    obs = _obs(29, 5)
    want = jsrv.serve([(jsrv.open_session(), o) for o in obs])
    got = tsrv.serve([(tsrv.open_session(), o) for o in obs])
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_worker_thread_serves_and_stops():
    srv = _server("int8", buckets=(4, 16))
    with srv:
        sids = [srv.open_session() for _ in range(10)]
        reqs = [srv.submit(sid, o) for sid, o in zip(sids, _obs(10))]
        results = [r.result(timeout=30) for r in reqs]
    assert all(r.version == 0 for r in results)
    stats = srv.stats()
    assert stats["served"] == 10 and not stats["worker"]["alive"]
    assert stats["worker"]["dispatch_failures"] == 0


def test_server_device_and_guards():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PolicyServer(SPEC)                       # default is the card
    srv = _server("int8")
    srv.warmup()
    with pytest.raises(ValueError):
        srv.submit(srv.open_session(), np.zeros(4, np.float32))
    cache = srv.current.cache
    w = cache["fc0"]["w"]
    bad = {**cache, "fc0": {**cache["fc0"], "w": ptq.PackedTensor(
        w.codes, -w.delta, w.zero_point, w.bits, w.col_scale, w.col_zero)}}
    with pytest.raises(guards.CodeRangeError, match="strictly"):
        guards.validate_cache(bad)
    w.codes[0, 0] ^= 1                              # flip a code bit
    with pytest.raises(guards.IntegrityError):
        srv.verify_current()


def test_greedy_calib_obs_on_airnav():
    env = make("airnav")
    tparams = networks.init_mlp(networks.mlp_spec(9, (16, 16), 25),
                                torch.Generator().manual_seed(0), "cpu")
    q = actorq.pack_actor_params(tparams, 4)
    obs = greedy_calib_obs(env, q, 20, seed=1)
    assert tuple(obs.shape) == (20, 9) and bool(torch.isfinite(obs).all())
    again = greedy_calib_obs(env, q, 20, seed=1)
    assert torch.equal(obs, again)
