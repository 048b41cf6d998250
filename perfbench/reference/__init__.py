"""The benchmark's plain reference: a frozen copy of the plain PyTorch path of
``leibnizgym_tpu_torch`` (the MDP layer of ``envs/trifinger/env.py``, the
plain physics step ``ops/engine_v2.py`` that ``csrc/physics_step.cu``
computes, the networks and the PPO epoch of ``learning/ppo.py``), taken at
the commit that added the benchmark and rewired to import only this folder.

It imports nothing of the program: the comparison that decides ``correct``
then holds later versions of the program to the semantics frozen here, and a
change of the program cannot move its own yardstick. The copies keep the
program's docstrings; where those name ``leibnizgym_tpu_torch`` modules,
they say where each function was copied from. What was left out: the CUDA
kernel and its wrapper, the CUDA-graph paths, the stateful ``TrifingerEnv``
and the data-parallel collectives (``ppo.py`` defines their one-process
forms). ``task.py`` builds the static and params of a task config as
``TrifingerEnv`` does.
"""
