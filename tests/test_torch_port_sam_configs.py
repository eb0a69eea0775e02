"""The SAM encoder's kernel configurations in the PyTorch port vs the JAX package.

``SamConfig``'s four encoder knobs (``window_attn_impl``, ``global_attn_impl``,
``mlp_impl``, ``tail_impl``) select the same computation in both packages;
here the port's ``Sam`` under each value is held against the JAX ``Sam``
under the same value, both on the CPU in fp32 with the same weights (a tiny
SAM whose windows pad; its 6 x 6 global grid takes the split-head path of
fewer than 2048 tokens), and ``--sam-override`` is shown to reach the model.
The kernel modes behind each value are held against their Pallas twins in
tests/test_torch_port_kernels.py.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samrs_tpu.core.config import SamConfig as JaxSamConfig
from samrs_tpu.core.config import sam_config as jax_sam_config
from samrs_tpu.sam import Sam as JaxSam
from samrs_tpu.sam.build import init_sam_variables
from samrs_tpu_torch.core.config import SamConfig, sam_config
from samrs_tpu_torch.generate import semantic
from samrs_tpu_torch.sam import build_sam
from samrs_tpu_torch.sam.port import jax_params_to_torch

TINY = dict(image_size=96, patch_size=16, window_size=4, encoder_embed_dim=32,
            encoder_depth=3, encoder_num_heads=2, encoder_global_attn_indexes=(2,),
            prompt_embed_dim=32, mask_in_chans=8, decoder_mlp_dim=64, decoder_num_heads=2,
            iou_head_hidden_dim=32)
TOL = 1e-4  # fp32 both sides; only summation order differs
KNOBS = {"window_attn_impl": JaxSamConfig.WINDOW_ATTN_IMPLS,
         "global_attn_impl": JaxSamConfig.GLOBAL_ATTN_IMPLS,
         "mlp_impl": JaxSamConfig.MLP_IMPLS, "tail_impl": JaxSamConfig.TAIL_IMPLS}
# every knob value alone, and the tail fusion with the windowed layers it couples to
CONFIGS = [{k: v} for k, vals in KNOBS.items() for v in vals]
CONFIGS += [dict(tail_impl="fused", window_attn_impl=w) for w in ("fused2", "block_row", "block2")]
CONFIGS += [dict(tail_impl="fused", mlp_impl="xla")]


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    """State fp32 for the port's matmuls and convs (TF32 off)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.fixture(scope="module")
def weights():
    """JAX variables with every leaf drawn with numpy (none left at zero) and
    one seeded input image.  The parameter tree is the same under every
    configuration."""
    jcfg = jax_sam_config("vit_b", **TINY, compute_dtype="float32")
    shapes = jax.eval_shape(lambda: init_sam_variables(JaxSam(jcfg), seed=0))
    flat = flax.traverse_util.flatten_dict(shapes)
    rng = np.random.default_rng(1)
    for k, s in sorted(flat.items()):
        v = rng.normal(size=s.shape).astype(np.float32)
        if k[-1] == "scale":
            v = 1.0 + 0.1 * v
        elif k[-1] == "kernel":
            v = v * np.prod(s.shape[:-1]) ** -0.5
        else:
            v = 0.1 * v
        flat[k] = v.astype(np.float32)
    x = np.random.default_rng(2).normal(size=(2, 96, 96, 3)).astype(np.float32)
    return flax.traverse_util.unflatten_dict(flat), x


def test_knobs_match_jax():
    """Names, defaults and value sets of the four knobs are the JAX package's."""
    got, want = SamConfig(), JaxSamConfig()
    for knob, values in KNOBS.items():
        assert getattr(got, knob) == getattr(want, knob), knob
        assert tuple(getattr(SamConfig, knob.upper() + "S")) == tuple(values), knob


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_unknown_knob_value_raises(knob):
    with pytest.raises(ValueError, match=f"unknown {knob}"):
        sam_config("vit_b", **{knob: "nope"})


@pytest.mark.parametrize("knobs", CONFIGS, ids=lambda k: ",".join(f"{a}={b}" for a, b in k.items()))
def test_encoder_matches_jax_under_config(weights, knobs):
    jvars, x = weights
    jmodel = JaxSam(jax_sam_config("vit_b", **TINY, compute_dtype="float32", **knobs))
    want = np.asarray(jax.jit(lambda v, a: jmodel.apply(v, a, method=JaxSam.encode_image))(
        jvars, jnp.asarray(x)))
    model = build_sam("vit_b", device="cpu", **TINY, **knobs)
    model.load_state_dict(jax_params_to_torch(jvars, sam_config("vit_b", **TINY)), strict=True)
    got = model.encode_image(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 6, 6, 32)
    assert float(np.linalg.norm(got - want) / np.linalg.norm(want)) <= TOL


@pytest.mark.parametrize("knobs, partition_free, residual_in_kernel, tail_fused", [
    ({}, True, False, False),
    (dict(tail_impl="fused"), True, False, True),
    (dict(tail_impl="fused", window_attn_impl="fused2"), True, False, True),
    (dict(tail_impl="fused", window_attn_impl="block_row"), True, False, False),
    (dict(tail_impl="fused", window_attn_impl="blockq"), True, False, False),
    (dict(tail_impl="fused", window_attn_impl="block2"), True, True, False),
    (dict(tail_impl="fused", mlp_impl="xla"), True, False, False),
    (dict(tail_impl="fused", window_attn_impl="fused"), False, False, False),
    (dict(window_attn_impl="pallas"), False, False, False),
])
def test_block_coupling_follows_jax(knobs, partition_free, residual_in_kernel, tail_fused):
    """The windowed blocks derive partition_free / residual_in_kernel /
    tail_fused as samrs_tpu/sam/image_encoder.py's Block does; the global
    blocks take none of them."""
    model = build_sam("vit_b", device="cpu", **TINY, **knobs)
    windowed, glob = model.image_encoder.blocks[0], model.image_encoder.blocks[2]
    assert (windowed.partition_free, windowed.residual_in_kernel, windowed.tail_fused) == (
        partition_free, residual_in_kernel, tail_fused)
    assert not (glob.partition_free or glob.residual_in_kernel or glob.tail_fused)


def test_cli_sam_override_reaches_the_model(monkeypatch, tmp_path):
    """``--sam-override window_attn_impl=pallas`` (a string knob, coerced by
    the default's type) arrives in the model's blocks."""
    seen = {}

    def fake_generate(cfg, sam_overrides=None):
        seen["model"] = build_sam(cfg.sam_variant, device=cfg.device, **sam_overrides)

    monkeypatch.setattr(semantic, "generate_semantic", fake_generate)
    overrides = [f"{k}={','.join(map(str, v)) if isinstance(v, tuple) else v}"
                 for k, v in TINY.items()]
    argv = ["--device", "cpu", "--sam-variant", "vit_b", "--image-dir", str(tmp_path),
            "--ann-dir", str(tmp_path), "--save-dir", str(tmp_path)]
    for o in overrides + ["window_attn_impl=pallas", "global_attn_impl=exp2", "tail_impl=fused"]:
        argv += ["--sam-override", o]
    semantic.main(argv)
    model = seen["model"]
    assert (model.cfg.window_attn_impl, model.cfg.global_attn_impl, model.cfg.tail_impl) == (
        "pallas", "exp2", "fused")
    assert {b.window_attn_impl for b in model.image_encoder.blocks} == {"pallas"}
    assert {b.global_attn_impl for b in model.image_encoder.blocks} == {"exp2"}
    with pytest.raises(SystemExit, match="unknown SamConfig field"):
        semantic.main(argv[:-2] + ["--sam-override", "compute_dtype=float32"])
