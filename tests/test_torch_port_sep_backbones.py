"""The SEP pretrain step of the three backbone families this file covers —
ResNet, Swin, ViTAEv2, each tiny, under a 16-wide UperNet and three heads —
in the PyTorch port vs the JAX package's ``make_pretrain_step``, on CPU in
fp32.

A module-scoped fixture, parametrised over the families, runs JAX's step
(one compile a family) and the port's; four tests check it.  From the
same numpy-drawn state (draw_variables, bridged with
``jax_params_to_torch`` and loaded strictly) and the same batches (4 / 3 / 5
images at 64^2, some pixels ignored), under the family's optimizer row
(weight decay 0.05 / 0.01, no layer decay): each head's loss within 1e-5 and
every BatchNorm's running statistics after the step within TOL (1e-4);
Swin's and ViTAE's first-step gradients (Adam's first moment, 0.1 x the
clipped gradient) and parameters after the update each within TOL.  flax's
BatchNorm forms the batch variance as E[x^2] - E[x]^2; JAX's step runs here
with the two-pass variance that torch computes (``_compute_stats``
patched while the fixture runs it), whose rounding is the port's.  Parameters without a true gradient hold
rounding noise on both sides, to 1e-6 of the gradient's norm, and the
update moves them by up to one Adam step (lr) either way, so they are held
within 2 lr: the biases that a BatchNorm removes next (UperNet's laterals
after Swin's LayerNorm out-norms; the convs before ViTAE's PCM
BatchNorms) and the key third of every attention's qkv bias (a softmax over
keys does not see it).

ResNet's every ReLU follows a BatchNorm of batch statistics, and fp32
rounding decides the side of the kink for values within ~1e-6 of it:
JAX's own first-step gradients move by 2.8e-3 - 3.2e-3 (rel-L2 over all
parameters) when its images are scaled by 1 -+ 1e-7, and the port's lie
1.7e-3 from JAX's.  So ResNet's gradients are held by the control rule of
the card's step comparisons (chip_smoke.py ``compare_steps``): within
CONTROL_FACTOR (3) times JAX's own distance under those two scalings.  The
first AdamW step moves a coordinate by lr g / (|g| + eps), about lr times
the sign of its gradient g (plus the decay), so its parameters are held
coordinate by coordinate: to rounding plus the difference of the two
sides' steps from their own gradients (2 lr where the signs differ).
ResNet's module gradients are held exactly, in float64, in
test_torch_port_resnet.py, where the modules themselves are, as Swin's and
ViTAE's are in test_torch_port_swin.py and test_torch_port_vitae.py.
"""

import re

import flax.linen.normalization as flax_norm
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from samrs_tpu.seg.backbones import resnet as jax_resnet
from samrs_tpu.seg.backbones import swin as jax_swin
from samrs_tpu.seg.backbones import vitae as jax_vitae
from samrs_tpu.seg.decoders.upernet import UPerHead as JaxUPerHead
from samrs_tpu.seg.frameworks import MultiHeadSegModel as JaxMultiHead
from samrs_tpu.seg.frameworks import SegHead as JaxSegHead
from samrs_tpu.train import optim as jax_optim
from samrs_tpu.train.trainer import TrainState as JaxTrainState
from samrs_tpu.train.trainer import make_pretrain_step
from samrs_tpu_torch.seg.backbones import resnet, swin, vitae
from samrs_tpu_torch.seg.decoders.upernet import UPerHead
from samrs_tpu_torch.seg.frameworks import MultiHeadSegModel, SegHead
from samrs_tpu_torch.seg.port import jax_params_to_torch
from samrs_tpu_torch.train import optim
from samrs_tpu_torch.train.trainer import TrainState, pretrain_step
from test_torch_port_resnet import TINY as RESNET_TINY
from test_torch_port_resnet import two_torch_threads  # noqa: F401 (autouse)
from test_torch_port_seg import _rel_l2, draw_variables
from test_torch_port_swin import TINY as SWIN_TINY
from test_torch_port_vit_adapter import TOL
from test_torch_port_vit_adapter_train import (_adam_state, assert_sep_gradients,
                                               assert_sep_losses_and_stats)
from test_torch_port_vitae import TINY as VITAE_TINY

SIZE = 64
BATCH = (4, 3, 5)  # >= 3 a head: the 1x1 PPM branch's BatchNorm sees one value per image
CLASSES = (3, 4, 5)
WARMUP, TOTAL, OFFSET = 2, 20, 5  # the row's peak lr; the schedule past its warmup
CONTROL_FACTOR = 3.0  # chip_smoke.py's: kernels vs plain within 3x a control's distance
ADAM_EPS = 1e-8
# family -> (JAX encoder, port encoder, registry name for the optimizer row)
FAMILIES = {
    "resnet": (lambda: jax_resnet.ResNet(**RESNET_TINY), lambda: resnet.ResNet(**RESNET_TINY),
               "resnet50"),
    "swin": (lambda: jax_swin.Swin(**SWIN_TINY), lambda: swin.Swin(**SWIN_TINY), "swin_t"),
    "vitae": (lambda: jax_vitae.ViTAEv2(**VITAE_TINY), lambda: vitae.ViTAEv2(**VITAE_TINY),
              "vitaev2_s"),
}


class TinyJax(JaxMultiHead):
    def setup(self):
        self._block_remat = False
        self.encoder = FAMILIES[self.backbone][0]()
        self.seg_decoder = JaxUPerHead(channels=16)
        self.heads = [JaxSegHead(nc, kernel=1, dropout=0.0, name=f"head_{i}")
                      for i, nc in enumerate(self.num_classes)]


class TinyPort(MultiHeadSegModel):
    """The port's MultiHeadSegModel with a tiny encoder of `family`, a
    16-wide UperNet and 1x1 heads, without dropout (the two packages' random
    streams differ)."""

    def __init__(self, family):
        nn.Module.__init__(self)
        self.use_kernels = True
        self.backbone, self.decoder = FAMILIES[family][2], "upernet"
        self.num_classes = CLASSES
        self.encoder = FAMILIES[family][1]()
        self.seg_decoder = UPerHead(self.encoder.out_channels[1:], channels=16)
        self.heads = nn.ModuleList(SegHead(16, nc, 1) for nc in CLASSES)


def no_grad_biases(model):
    """Biases that a BatchNorm removes next: UperNet's 1x1 laterals (no bias)
    and BatchNorms follow Swin's LayerNorm out-norms of c1..c3; a PCM's first
    and second convs feed its BatchNorms."""
    return tuple(n.removeprefix("encoder.") for n, _ in model.named_parameters()
                 if re.fullmatch(r"encoder\.(norm[0-2]\.bias|.*PCM\.[03]\.bias)", n))


def sep_first_step(family, seed=31):
    """One SEP step of the tiny `family` + UperNet from the same numpy-drawn
    state through JAX's ``make_pretrain_step`` and the port's
    ``pretrain_step``: both sides in the port's names (losses, state after
    the step, Adam's first moment, as the assert_sep_* helpers take them),
    the row's lr, the port's model, and ``jax_mu(s)``: JAX's first moment
    with the images scaled by 1 + s (the compiled step run again)."""
    jm = TinyJax(backbone=family, decoder="upernet", num_classes=CLASSES, image_size=SIZE)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            [jnp.zeros((1, SIZE, SIZE, 3))] * 3, True))
    jvars = draw_variables(shapes, seed)
    stats = jvars.get("batch_stats", {})
    rng = np.random.default_rng(seed + 1)
    batches = []
    for b, nc in zip(BATCH, CLASSES):
        y = rng.integers(0, nc, (b, SIZE, SIZE)).astype(np.int32)
        y[:, :5] = 255  # some ignored pixels
        batches.append((rng.normal(size=(b, SIZE, SIZE, 3)).astype(np.float32), y))
    row = optim.backbone_optim_settings(FAMILIES[family][2])
    kw = dict(weight_decay=row["weight_decay"], grad_clip=5.0, layer_decay=row["layer_decay"])
    jsched = jax_optim.warmup_cosine_schedule(row["lr"], TOTAL, WARMUP)
    tx = jax_optim.build_optimizer(jvars["params"], lambda c: jsched(c + OFFSET), **kw)
    model = TinyPort(family)
    model.load_state_dict(jax_params_to_torch(jvars["params"], stats), strict=True)
    psched = optim.warmup_cosine_schedule(row["lr"], TOTAL, WARMUP)
    state = TrainState(0, model, optim.Optimizer(model, lambda s: psched(s + OFFSET), **kw))
    step = make_pretrain_step(jm, tx)

    def jax_step(side):
        return step(JaxTrainState.create(jvars["params"], stats, tx),
                    tuple((jnp.asarray(x * np.float32(1 + side)), jnp.asarray(y))
                          for x, y in batches), jax.random.PRNGKey(0))

    jstate, jmetrics = jax_step(0.0)
    pmetrics = pretrain_step(state, [(torch.from_numpy(x), torch.from_numpy(y))
                                     for x, y in batches], 0)
    names = {p: n for n, p in model.named_parameters()}
    run = dict(
        jloss=[float(jmetrics[f"loss_{i}"]) for i in range(3)],
        ploss=[float(pmetrics[f"loss_{i}"]) for i in range(3)],
        jstate=jax_params_to_torch(jstate.params, jstate.batch_stats),
        pstate={k: v.clone() for k, v in model.state_dict().items()},
        jmu=jax_params_to_torch(_adam_state(jstate.opt_state).mu),
        pmu={names[p]: s["exp_avg"].clone() for p, s in state.optimizer.opt.state.items()},
        stats={k for k in model.state_dict() if k.rsplit(".", 1)[1].startswith("running_")})
    return run, row["lr"], model, lambda s: jax_params_to_torch(_adam_state(
        jax_step(s)[0].opt_state).mu)


def _dist(got, want, skip):
    """rel-L2 of `got` against `want` over all their tensors but `skip`."""
    keys = [k for k in want if k not in skip]
    d2 = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in keys)
    return (d2 / sum(float((want[k].double() ** 2).sum()) for k in keys)) ** 0.5


def _split_key_bias(k, got, want):
    """(the coordinates held to TOL, those held within 2 lr) of parameter k:
    a qkv bias's key third has no true gradient."""
    if not k.endswith("qkv.bias"):
        return (got, want), (got[:0], want[:0])
    n = got.shape[0] // 3
    return ((np.concatenate([got[:n], got[2 * n:]]), np.concatenate([want[:n], want[2 * n:]])),
            (got[n:2 * n], want[n:2 * n]))


def assert_parameters(run, no_grad, lr):
    """Every parameter after the update within TOL of JAX's (rel-L2); the
    `no_grad` ones and the key thirds of the qkv biases within 2 lr."""
    for k in run["jmu"]:
        got, want = run["pstate"][k].numpy(), run["jstate"][k].numpy()
        if k.removeprefix("encoder.") in no_grad:
            assert np.abs(got - want).max() <= 2.0 * lr, k
            continue
        (g, w), (gk, wk) = _split_key_bias(k, got, want)
        assert _rel_l2(g, w) <= TOL, (k, _rel_l2(g, w))
        assert gk.size == 0 or np.abs(gk - wk).max() <= 2.0 * lr, k


def assert_kinked_parameters(run, lr):
    """ResNet's parameters after the update: every coordinate within 1e-6 of
    its tensor's largest value of JAX's plus the difference of the two Adam
    steps that the two gradients g give, lr g / (|g| + eps) (2 lr where they
    differ in sign)."""
    for k, jmu in run["jmu"].items():
        got, want = run["pstate"][k].numpy(), run["jstate"][k].numpy()
        # Adam's first moment after one step is 0.1 x the (clipped) gradient
        gp, gj = 10.0 * run["pmu"][k].numpy(), 10.0 * jmu.numpy()
        steps = lr * np.abs(gp / (np.abs(gp) + ADAM_EPS) - gj / (np.abs(gj) + ADAM_EPS))
        assert (np.abs(got - want) <= steps + 1e-6 * np.abs(want).max()).all(), k


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def sep_run(request):
    """(family, the run, the row's lr, the no-gradient biases, and for
    ResNet the control: JAX's own first-moment distance under its images
    scaled by 1 -+ 1e-7, the larger), with JAX's BatchNorms on the two-pass
    variance."""
    family = request.param
    with pytest.MonkeyPatch.context() as mp:
        compute = flax_norm._compute_stats
        mp.setattr(flax_norm, "_compute_stats",
                   lambda *a, **k: compute(*a, **{**k, "use_fast_variance": False}))
        run, lr, model, jax_mu = sep_first_step(family)
        control = max(_dist(jax_mu(s), run["jmu"], ()) for s in (1e-7, -1e-7)) \
            if family == "resnet" else None
    return family, run, lr, no_grad_biases(model), control


def test_sep_losses_match_jax(sep_run):
    """Each head's cross-entropy within 1e-5 (the three train-mode forwards
    of ``make_pretrain_step``, one a head in head order)."""
    _, run, _, _, _ = sep_run
    np.testing.assert_allclose(run["ploss"], run["jloss"], rtol=1e-5)


def test_sep_batch_stats_match_jax(sep_run):
    """Every BatchNorm's running statistics after the step (UperNet's; ResNet's
    and ViTAE's own), each updated once a head, within TOL."""
    family, run, _, _, _ = sep_run
    assert "seg_decoder.fpn_bottleneck.bn.running_var" in run["stats"]
    assert (family == "swin") == (sum(k.startswith("encoder.") for k in run["stats"]) == 0)
    assert_sep_losses_and_stats(run, {"seg_decoder.fpn_bottleneck.bn.running_var"})


def test_sep_first_step_gradients_match_jax(sep_run):
    """Every first-step gradient: Swin's and ViTAE's each within TOL (the
    no-gradient biases to noise); ResNet's within CONTROL_FACTOR times JAX's
    own distance under a 1e-7 input scaling."""
    family, run, _, no_grad, control = sep_run
    if family == "resnet":
        dist = _dist(run["pmu"], run["jmu"], ())
        assert 0.0 < dist <= CONTROL_FACTOR * control, (dist, control)
        return
    assert len(no_grad) == (3 if family == "swin" else 16)
    assert_sep_gradients(run, no_grad)


def test_sep_updated_parameters_match_jax(sep_run):
    """The parameters after the first AdamW update: Swin's and ViTAE's
    within TOL (the no-gradient ones within 2 lr), ResNet's coordinate by
    coordinate against the two sides' Adam steps."""
    family, run, lr, no_grad, _ = sep_run
    if family == "resnet":
        assert_kinked_parameters(run, lr)
    else:
        assert_parameters(run, no_grad, lr)
