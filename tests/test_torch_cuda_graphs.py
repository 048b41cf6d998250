"""The port's CUDA graphs on the card (marker ``cuda``; skips without a
GPU): the captured epoch (``learning/graphs.py``; alone, as the one rank of
an NCCL group and with ``nan_telemetry``), the captured play policy and env
step (``envs/trifinger/env.py``; the policy also as the one rank of an
NCCL group) against the eager functions fed the same draws; the epoch's
graph replays (``ops/capture.py`` ``replay_count``) and device marks
(``utils/trace.py``). No JAX here,
so it runs on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py

Their CPU counterparts are in ``tests/test_torch_graphs.py``.
"""

import os

import pytest
import torch
import torch.distributed as dist

import torch_parallel_workers as workers
from leibnizgym_tpu_torch.envs.trifinger import env as tenv
from leibnizgym_tpu_torch.learning import graphs as tgraphs
from leibnizgym_tpu_torch.learning import ppo as tppo
from leibnizgym_tpu_torch.ops import capture, cuda_engine
from leibnizgym_tpu_torch.parallel.mesh import all_reduce_mean_, data_shard

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def test_graphed_epoch_on_the_card(dev):
    """Three captured epochs at 256 envs against ``train_iteration`` from the
    same generator state: metrics, learner and carry bitwise equal, and the
    graphed epochs count their kernel launches, 96 each (a physics, a
    fingertip and a tail launch per env step)."""
    env = tenv.TrifingerEnv(config={"num_instances": 256, "command_mode": "torque",
                                    "asymmetric_obs": True}, device=dev, verbose=False)
    cfg = tppo.PPOConfig(minibatch_size=256, cv_minibatch_size=256)
    eager = tppo.init_train_state(cfg, env.static, env.params, 0)
    graphed = tppo.init_train_state(cfg, env.static, env.params, 0)
    epoch = tgraphs.GraphedEpoch()
    for e in range(3):
        me = tppo.train_iteration(cfg, env.static, env.params, eager)
        before = cuda_engine.launch_count
        mg = epoch(cfg, env.static, env.params, graphed)
        assert cuda_engine.launch_count - before == 3 * cfg.horizon
        torch.cuda.synchronize()
        for k, v in me.items():
            assert torch.equal(v, mg[k]) if torch.is_tensor(v) else v == mg[k], (e, k)
        for a, b in zip(eager.learner_tensors(), graphed.learner_tensors()):
            assert torch.equal(a, b), e
        assert torch.equal(eager.ac_opt.count, graphed.ac_opt.count)
        ta = tenv.env_state_tensors(eager.carry.env_state)
        tb = tenv.env_state_tensors(graphed.carry.env_state)
        assert all(torch.equal(ta[k], tb[k]) for k in ta), e
    assert epoch.graphs is not None


def test_env_step_graph_on_the_card(dev):
    """The captured env reset and step against the eager functions from the
    same draws and actions: bitwise equal outputs and state (after the first
    reset too), an obs kept by the caller unchanged by the next step, one
    physics, one fingertip and one tail kernel launch per call, the captured
    ones counted from the replays."""
    n = 512
    env = tenv.TrifingerEnv(config={"num_instances": n, "command_mode": "torque",
                                    "asymmetric_obs": True}, device=dev, verbose=False)
    st = env.static
    gen = torch.Generator(device=dev).manual_seed(0)
    init = tenv.draw_init_randoms(st, gen, n, dev)
    before = cuda_engine.launch_count
    obs = env.reset(init)
    state, ref_obs = tenv.env_reset(st, env.params, *init)
    assert torch.equal(obs, ref_obs)
    ours, ref = tenv.env_state_tensors(env.state), tenv.env_state_tensors(state)
    assert all(torch.equal(ours[k], ref[k]) for k in ref)  # the first reset's state
    kept = None
    for t in range(5):
        action = torch.rand((n, st.action_dim), generator=gen, device=dev) * 2.0 - 1.0
        draws = tenv.draw_step_randoms(st, gen, n, dev)
        obs, reward, dones, info = env.step(action, draws)
        state, ref_obs, _, ref_reward, ref_dones, ref_info = tenv.env_step(
            st, env.params, state, action, draws)
        assert torch.equal(obs, ref_obs) and torch.equal(reward, ref_reward), t
        assert torch.equal(dones, ref_dones) and set(info) == set(ref_info), t
        if kept is not None:
            assert torch.equal(kept[0], kept[1]), t
        kept = (obs, obs.clone())
    assert cuda_engine.launch_count - before == 2 * 3 * (1 + 5)
    ours, ref = tenv.env_state_tensors(env.state), tenv.env_state_tensors(state)
    assert all(torch.equal(ours[k], ref[k]) for k in ref)


def _env(dev, n=256, shard=None):
    return tenv.TrifingerEnv(config={"num_instances": n, "command_mode": "torque",
                                     "asymmetric_obs": True}, device=dev, verbose=False,
                             shard=shard)


def _same_epoch(me, mg, eager, graphed, where):
    assert set(me) == set(mg), where
    for k, v in me.items():
        assert torch.equal(v, mg[k]) if torch.is_tensor(v) else v == mg[k], (where, k)
    a = workers._train_state_tensors(eager)
    b = workers._train_state_tensors(graphed)
    assert not workers._unequal(a, b), (where, workers._unequal(a, b))


def test_nccl_rank_graphed_epoch_on_the_card(dev, tmp_path):
    """The one rank of an NCCL group: three captured epochs, its collectives
    in the graphs, against the same rank's eager epochs and against the
    captured epochs without a group, from the same generator state: all
    bitwise equal; each epoch 64 kernel launches and the eager epoch's
    collectives (one all-reduce per minibatch step, two for the advantages,
    one for the metrics, run after the replays), counted from the replays."""
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous",
                            world_size=1, rank=0)
    try:
        env = _env(dev, shard=data_shard(256))
        shard = env.shard
        cfg = tppo.PPOConfig(minibatch_size=256, cv_minibatch_size=256)
        eager = tppo.init_train_state(cfg, env.static, env.params, 0, shard=shard)
        graphed = tppo.init_train_state(cfg, env.static, env.params, 0, shard=shard)
        plain = tppo.init_train_state(cfg, env.static, env.params, 0)
        epoch, alone = tgraphs.GraphedEpoch(), tgraphs.GraphedEpoch()
        for e in range(3):
            shard.counts.clear()
            me = tppo.train_iteration(cfg, env.static, env.params, eager)
            counts = dict(shard.counts)
            shard.counts.clear()
            before = cuda_engine.launch_count
            mg = epoch(cfg, env.static, env.params, graphed)
            assert cuda_engine.launch_count - before == 3 * cfg.horizon, e
            assert dict(shard.counts) == counts == {
                "all_reduce": epoch.ac_steps + epoch.cv_steps + 3}, (e, counts)
            mp = alone(cfg, env.static, env.params, plain)
            torch.cuda.synchronize()
            _same_epoch(me, mg, eager, graphed, f"epoch {e} nccl eager vs graphed")
            _same_epoch(mp, mg, plain, graphed, f"epoch {e} plain vs nccl, graphed")
        assert epoch.graphs is not None and alone.graphs is not None
    finally:
        dist.destroy_process_group()


def test_graphed_epoch_replays_and_device_marks_on_the_card(dev, monkeypatch):
    """Inside an ``epoch`` span, as ``Runner.train`` calls it: the warm-up
    epoch counts no replay and a replayed one 2 + ``ac_steps`` +
    ``cv_steps``; each epoch's four device marks (the warm-up's on its side
    stream) resolve once its metrics have been read back, in order; no mark
    is recorded while the graphs are captured."""
    from leibnizgym_tpu_torch.learning.runner import fetch_metrics
    from leibnizgym_tpu_torch.utils import trace

    marks = []
    mark = trace.mark

    def watched(phase, cuda):
        marks.append((phase, torch.cuda.is_current_stream_capturing()))
        mark(phase, cuda)

    monkeypatch.setattr(trace, "mark", watched)
    env = _env(dev)
    cfg = tppo.PPOConfig(minibatch_size=256, cv_minibatch_size=256)
    ts = tppo.init_train_state(cfg, env.static, env.params, 0)
    epoch = tgraphs.GraphedEpoch()
    trace.sync_clock()
    for e in range(3):
        marks.clear()
        before = capture.replay_count
        with trace.span("epoch") as span:
            metrics = epoch(cfg, env.static, env.params, ts)
        replays = capture.replay_count - before
        assert replays == (0 if e == 0 else 2 + epoch.ac_steps + epoch.cv_steps), (e, replays)
        assert marks == [(p, False) for p in ("start", "rollout", "gae", "update")], (e, marks)
        fetch_metrics(metrics)
        trace.resolve(span)
        m = span.marks_ms
        assert m is not None and list(m) == ["start", "rollout", "gae", "update"], e
        assert 0 <= m["start"] < m["rollout"] < m["gae"] < m["update"], (e, m)
    assert epoch.graphs is not None


def test_graphed_nan_telemetry_epoch_on_the_card(dev):
    """``nan_telemetry`` captured: three epochs against the eager ones from
    the same generator state, every ``nan/*`` metric included, bitwise."""
    env = _env(dev)
    cfg = tppo.PPOConfig(minibatch_size=256, cv_minibatch_size=256, nan_telemetry=True)
    eager = tppo.init_train_state(cfg, env.static, env.params, 0)
    graphed = tppo.init_train_state(cfg, env.static, env.params, 0)
    epoch = tgraphs.GraphedEpoch()
    for e in range(3):
        me = tppo.train_iteration(cfg, env.static, env.params, eager)
        mg = epoch(cfg, env.static, env.params, graphed)
        torch.cuda.synchronize()
        assert len([k for k in mg if k.startswith("nan/")]) == 22
        _same_epoch(me, mg, eager, graphed, f"epoch {e}")
    assert epoch.graphs is not None and epoch.ac_terms.shape[0] == 6


@pytest.mark.parametrize("group", [None, "nccl"])
def test_graphed_policy_on_the_card(dev, group, tmp_path):
    """The captured play policy, deterministic and with noise, against the
    eager policy on changing obs and, once, another env count (a new
    capture): bitwise equal actions, a returned action unchanged by the next
    call, the generators in step. As the one rank of an NCCL group the
    policy is captured and replayed with an eager all-reduce still queued
    before each call, as ``Runner.play`` issues them."""
    shard = None
    if group is not None:
        dist.init_process_group(group, init_method=f"file://{tmp_path}/rendezvous",
                                world_size=1, rank=0)
    try:
        env = _env(dev, shard=data_shard(256) if group is not None else None)
        shard = env.shard
        cfg = tppo.PPOConfig(minibatch_size=256, cv_minibatch_size=256)
        ts = tppo.init_train_state(cfg, env.static, env.params, 0, shard=shard)
        tppo.train_iteration(cfg, env.static, env.params, ts)
        for deterministic in (True, False):
            policy = tgraphs.GraphedPolicy(cfg, ts.actor_critic, 256, deterministic, shard)
            g_eager = torch.Generator(device=dev).manual_seed(1)
            g_graph = torch.Generator(device=dev).manual_seed(1)
            kept = None
            for t in range(6):
                obs = ts.carry.obs * (1.0 + t) if t != 4 else ts.carry.obs[:128]
                policy.n_draw = obs.shape[0]
                want = workers.eager_policy(cfg, ts.actor_critic, obs, deterministic,
                                            obs.shape[0], shard, g_eager)
                if shard is not None:
                    mean_r = want.mean()
                    all_reduce_mean_([mean_r], shard)
                got = policy(obs, g_graph)
                assert torch.equal(want, got), (group, deterministic, t)
                if kept is not None:
                    assert torch.equal(kept[0], kept[1]), (group, deterministic, t)
                kept = (got, got.clone())
            assert policy.captured.graph is not None
            assert torch.equal(g_eager.get_state(), g_graph.get_state())
    finally:
        if group is not None:
            dist.destroy_process_group()
