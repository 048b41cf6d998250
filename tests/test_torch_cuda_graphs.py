"""The port's CUDA graphs on the card (marker ``cuda``; skips without a
GPU): the captured epoch (``learning/graphs.py``) and env step
(``envs/trifinger/env.py``) against the eager functions fed the same draws.
No JAX here, so it runs on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_graphs.py

Their CPU counterparts are in ``tests/test_torch_graphs.py``.
"""

import pytest
import torch

from leibnizgym_tpu_torch.envs.trifinger import env as tenv
from leibnizgym_tpu_torch.learning import graphs as tgraphs
from leibnizgym_tpu_torch.learning import ppo as tppo
from leibnizgym_tpu_torch.ops import cuda_engine

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
    graphed epochs count their physics kernel launches, 32 each."""
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
        assert cuda_engine.launch_count - before == cfg.horizon
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
    kernel launch per call."""
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
    assert cuda_engine.launch_count - before == 2 * (1 + 5)
    ours, ref = tenv.env_state_tensors(env.state), tenv.env_state_tensors(state)
    assert all(torch.equal(ours[k], ref[k]) for k in ref)
