"""Parameter and Adam-moment distances of the InternImage step parity test
from the JAX init (every DCNv3 tap on a pixel at the first step).

    JAX_PLATFORMS=cpu python tests/internimage_moment_spread.py [THREADS_A THREADS_B] [--floor]

Runs the steps of ``test_pretrain_steps_from_jax_init_match`` twice, with
``torch.set_num_threads`` at THREADS_A and at THREADS_B (default 1 and 8),
and prints per step, for the DCNv3 sampling branch (depthwise conv, its
norm, offset and mask linears) and for every other parameter: the largest
per-tensor rel-L2 of the parameters and both moments between the port and
the JAX package at each thread count, and between the port's two runs (the
same code in another summation order).  The JAX side samples through
``dcnv3_pallas(interpret=True)``; with ``--floor``, through the same kernel
on coordinates moved off the two fp32 points per pixel where its derivative
is not the floor formula's (``_dcnv3_interpret_floor``).  A few minutes on
the CPU, most of it JAX's compile of the step.
"""

import os
import sys

import jax
import numpy as np
import torch

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]  # the tests' helpers and the repository
import test_torch_port_internimage as t  # noqa: E402


def worst(got, want, branch):
    rows = [(t._rel_l2(got[k].numpy(), v.numpy()), k) for k, v in want.items()
            if v.any() and t.sampling_branch(k) == branch]
    return max(rows) if rows else (0.0, "-")


def main():
    jax.config.update("jax_platforms", "cpu")
    args = [a for a in sys.argv[1:] if a != "--floor"]
    threads = [int(a) for a in args[:2]] or [1, 8]
    floor = "--floor" in sys.argv
    t.jax_internimage.dcnv3 = t._dcnv3_interpret_floor if floor else t._dcnv3_interpret
    print(f"JAX DCNv3: {'dcnv3_pallas on floor-safe coordinates' if floor else 'dcnv3_pallas'}",
          flush=True)
    side = t.make_jax_side()
    runs = {}
    for n in threads:
        torch.set_num_threads(n)
        runs[n] = t.run_steps(side, "jax")[2]
    a, b = threads
    for step in sorted(runs[a]):
        for branch in (True, False):
            label = "sampling branch" if branch else "the rest"
            for what, jkey, pkey in (("param", "jstate", "pstate"), ("mu", "jmu", "pmu"),
                                     ("nu", "jnu", "pnu")):
                vs_jax = [worst(runs[n][step][pkey], runs[n][step][jkey], branch) for n in threads]
                vs_port = worst(runs[a][step][pkey], runs[b][step][pkey], branch)
                print(f"step {step} {label} {what}: port vs JAX at {a} threads "
                      f"{vs_jax[0][0]:.3e} ({vs_jax[0][1]}), at {b} threads {vs_jax[1][0]:.3e} "
                      f"({vs_jax[1][1]}); port {a} vs {b} threads {vs_port[0]:.3e} "
                      f"({vs_port[1]})", flush=True)


if __name__ == "__main__":
    main()
