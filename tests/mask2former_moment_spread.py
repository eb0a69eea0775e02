"""Worst Adam-moment distance of the Mask2Former step parity tests.

    JAX_PLATFORMS=cpu python tests/mask2former_moment_spread.py [THREADS]

Runs the same steps as ``test_m2f_steps_match_jax_exact_mode`` (three
exact-mode steps) and ``test_m2f_step_matches_jax_point_mode`` (one
point-mode step) and prints, per step and moment, the largest per-tensor
rel-L2 between the port and the JAX package (with the tensor's name), the
rel-L2 over all parameters, and the largest parameter rel-L2.  THREADS
sets ``torch.set_num_threads`` first (default: torch's own count), to see
whether the distances depend on the summation order of the thread split.
About a minute on the CPU, most of it JAX's compile of the steps.
"""

import os
import sys

import jax
import numpy as np
import torch

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]  # the tests' helpers and the repository
import test_torch_port_mask2former as t  # noqa: E402


def worst(snap):
    out = {}
    for moment in ("mu", "nu"):
        want, got = snap["j" + moment], snap["p" + moment]
        live = [k for k, v in want.items() if v.any()]
        per = max((t._rel_l2(got[k].numpy(), want[k].numpy()), k) for k in live)
        whole = t._rel_l2(np.concatenate([got[k].numpy().ravel() for k in live]),
                          np.concatenate([want[k].numpy().ravel() for k in live]))
        out[moment] = dict(worst_tensor=per, all_parameters=whole)
    params = max(t._rel_l2(snap["pparams"][k].numpy(), v.numpy())
                 for k, v in snap["jparams"].items())
    return out, params


def main():
    jax.config.update("jax_platforms", "cpu")
    if len(sys.argv) > 1:
        torch.set_num_threads(int(sys.argv[1]))
    print(f"torch threads {torch.get_num_threads()}", flush=True)
    jm = t.TinyJaxM2F(num_classes=t.CLASSES, image_size=t.SIZE)
    xs0 = [jax.numpy.zeros((1, t.SIZE, t.SIZE, 3))] * 3
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), xs0, True))
    variables = (jm, t.draw_variables(shapes, 50)["params"])
    for i, snap in enumerate(t._run_steps(variables, None, 3)):
        print(f"exact mode, step {i + 1}:", *worst(snap), flush=True)
    snap = t._run_steps(variables, t.POINTS, 1, heads=(2,))[0]
    print("point mode, step 1:", *worst(snap), flush=True)


if __name__ == "__main__":
    main()
