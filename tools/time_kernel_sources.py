"""Time other versions of the physics kernel's source against this one.

    git show <rev>:leibnizgym_tpu_torch/csrc/physics_step.cu > build/old/physics_step.cu
    python3 tools/time_kernel_sources.py build/old/physics_step.cu [--block 32]

Runs chip_smoke.py's phases 4 (the D1 rollout at 8192 envs) and 6 (the
D4 + DR recipe trained for 4 epochs); where those phases time the kernel, each
other source is timed on the same inputs in turns with this checkout's kernel
(this, other, other, this; CUDA events over 50 launches each), next to its
registers, spills and worst difference to the plain version. Each other
source must have this one's ``LgConsts`` layout and C entry
``leibniz_physics_step``; ``--block B`` passes the extra int argument that
older versions take before the stream (the PR 1 kernel: threads per block,
32). Needs a CUDA device; build outputs go under build/.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from leibnizgym_tpu_torch.ops import cuda_engine  # noqa: E402
from leibnizgym_tpu_torch.ops.engine_v2 import WRENCH_ROWS, step_packed  # noqa: E402

REGS_PER_SM = 65536


def load(source: str):
    """Build ``source`` with the kernel's nvcc flags and load it; returns
    (library, ptxas record)."""
    with open(source, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(cuda_engine.NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = os.path.join(cuda_engine.BUILD_ROOT, "sources", digest)
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libphysics_step.so")
    cmd = [cuda_engine._nvcc(), *cuda_engine.NVCC_FLAGS, "-o", lib_path, source]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(lib_path)
    lib.leibniz_physics_step.restype = ctypes.c_int
    lib.leibniz_consts_size.restype = ctypes.c_int
    if lib.leibniz_consts_size() != ctypes.sizeof(cuda_engine._KernelConsts):
        raise RuntimeError(f"{source}: LgConsts layout differs from this checkout's")
    return lib, cuda_engine._parse_ptxas(proc.stdout + proc.stderr)


def launcher(lib, block, packed, cfg, dt):
    """A launch of ``lib``'s C entry on packed CUDA inputs."""
    s31, p40, t9 = packed
    n = s31.shape[1]
    out = torch.empty_like(s31)
    wrench = torch.empty((WRENCH_ROWS, n), dtype=torch.float32, device=s31.device)
    consts = cuda_engine.kernel_consts(cfg, dt)
    extra = () if block is None else (ctypes.c_int(block),)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (s31, p40, t9, out, wrench)]

    def launch():
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = lib.leibniz_physics_step(*ptrs, ctypes.c_int(n), ctypes.byref(consts), *extra, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out, wrench

    return launch


def main(argv) -> int:
    block = None
    if "--block" in argv:
        i = argv.index("--block")
        block = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if not argv or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    others = {os.path.relpath(os.path.abspath(p), ROOT): load(p) for p in argv}
    cuda_engine.build()
    info, occ = cuda_engine.build_info, cuda_engine.occupancy()
    print(f"{chip_smoke.smi()} this registers={info.get('registers')} "
          f"stack_frame_bytes={info.get('stack_frame_bytes')} "
          f"spill_load_bytes={info.get('spill_load_bytes')} "
          f"dynamic_smem_bytes_per_block={occ['dynamic_smem_bytes']} "
          f"envs_per_block={occ['envs_per_block']} threads_per_block={4 * occ['envs_per_block']} "
          f"resident_blocks_per_sm={occ['blocks_per_sm']}", flush=True)
    for name, (_, bi) in others.items():
        threads = block or 32
        regs = -(-bi["registers"] // 8) * 8 * threads  # per block, allocated in units of 8
        print(f"{chip_smoke.smi()} {name} registers={bi.get('registers')} "
              f"stack_frame_bytes={bi.get('stack_frame_bytes')} "
              f"spill_load_bytes={bi.get('spill_load_bytes')} "
              f"static_smem_bytes={bi.get('static_smem_bytes')} threads_per_block={threads} "
              f"resident_blocks_per_sm_by_registers={REGS_PER_SM // regs}", flush=True)

    time_kernel = chip_smoke.time_kernel

    def time_in_turns(tag, packed, cfg, dt):
        ours = lambda: cuda_engine.step_packed_cuda(*packed, cfg, dt)  # noqa: E731
        ref, _ = step_packed(*packed, cfg, dt)
        for name, (lib, _) in others.items():
            theirs = launcher(lib, block, packed, cfg, dt)
            out, _ = theirs()
            err = float((out - ref).abs().max())
            ours()
            turns = [chip_smoke.cuda_ms(f, 50) for f in (ours, theirs, theirs, ours)]
            print(f"{chip_smoke.smi()} physics_step {tag} n={packed[0].shape[1]} "
                  f"this_ms={turns[0]:.4f},{turns[3]:.4f} other_ms={turns[1]:.4f},{turns[2]:.4f} "
                  f"other={name} speedup={(turns[1] + turns[2]) / (turns[0] + turns[3]):.3f} "
                  f"other_max_abs_err_to_plain={err:.3e}", flush=True)
        return time_kernel(tag, packed, cfg, dt)

    chip_smoke.time_kernel = time_in_turns
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.phase_slice(dev)
    chip_smoke.phase_d4(dev)
    if chip_smoke.failures:
        print(f"time_kernel_sources: {len(chip_smoke.failures)} check(s) failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
