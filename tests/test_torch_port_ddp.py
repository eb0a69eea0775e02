"""Data-parallel training in the PyTorch port (core/mesh.py, the trainer's
steps, the sharded loaders, synced BatchNorm, run_pretrain / run_finetune) on the CPU: two
ranks under gloo (tests/_ddp_worker.py, spawned once for the module) against
one process on the rank-ordered global batch, and against JAX.

  * the step, tiny vit_b_rvsa + UperNet with dropout and drop-path 0.1:
    two steps on two ranks equal two one-process steps on the global batch:
    the losses within 1e-6, the parameters, gradients, AdamW moments and
    BatchNorm statistics within 1e-6 or, where BatchNorm amplifies fp32
    summation order, within 3x a control's distance (the one-process run
    with every MLP product split into two K-halves); the statistics equal
    on both ranks; with the drops at 0, the loss and every gradient match
    jax.grad of ``make_pretrain_step``'s loss on the global batch;
  * a head with one image a rank takes BatchNorm's global branch (the
    forward equals the one-process forward on both images);
  * the loaders' shards make up the one-process batches; the rounding of
    the batches to the ranks is JAX's;
  * a finetune epoch on two ranks gives the one-process evaluation;
  * ``run_pretrain`` on two ranks: the same mIoU on both, checkpoints from
    rank 0 only, a resume that restores the step on both;
  * refusals: Mask2Former over several ranks, a mesh_shape that is not the
    world size.
Also core/logging_utils.py against the JAX module.
"""

import logging
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from samrs_tpu.core import logging_utils as jax_logging
from samrs_tpu.train.trainer import cross_entropy_ignore as jax_ce
from samrs_tpu_torch.core import logging_utils
from samrs_tpu_torch.data.datasets import ISPRS_PALETTE, DataLoader
from samrs_tpu_torch.kernels import fused_mlp
from samrs_tpu_torch.seg.decoders.blocks import BatchNorm
from samrs_tpu_torch.seg.port import jax_params_to_torch
from samrs_tpu_torch.train.finetune import evaluate_simple, run_finetune
from samrs_tpu_torch.train.pretrain import data_parallel_batch, proportional_batch_sizes
from samrs_tpu_torch.train.trainer import pretrain_step

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)
import _ddp_worker as W  # noqa: E402
from test_torch_port_seg import TINY_RVSA, _rel_l2, draw_variables  # noqa: E402
from test_torch_port_train import ZERO_GRAD, TinyJax  # noqa: E402

STEP_TOL = 1e-6      # two ranks vs one process: fp32 summation order only
CONTROL_FACTOR = 3.0  # chip_smoke.py's rule where BatchNorm amplifies that order
JAX_TOL = 1e-4       # port vs JAX, fp32 (test_torch_port_train.py's)
SPAWN_TIMEOUT = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def split_mlp_plain(x, w1, b1, w2, b2):
    """The plain MLP with each product split into two K-halves and added
    (chip_smoke.py's control)."""
    C, M = x.shape[-1], w1.shape[0]
    x2 = x.reshape(-1, C)
    h = x2[:, :C // 2] @ w1[:, :C // 2].t() + torch.addmm(b1, x2[:, C // 2:], w1[:, C // 2:].t())
    a = torch.nn.functional.gelu(h)
    out = a[:, :M // 2] @ w2[:, :M // 2].t() + torch.addmm(b2, a[:, M // 2:], w2[:, M // 2:].t())
    return out.reshape(x.shape)


def _write_tree(root, n, size, n_classes, rgb):
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(n * size + n_classes)
    names = [f"{root.name}_{i}" for i in range(n)]
    for nm in names:
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            root / "images" / f"{nm}.png")
        lbl = rng.integers(0, n_classes, (size, size))
        Image.fromarray(ISPRS_PALETTE[lbl] if rgb else lbl.astype(np.uint8)).save(
            root / "labels" / f"{nm}.png")
    return names


def _write_data(root):
    names = _write_tree(root / "potsdam", W.FT_TRAIN + W.FT_VAL, W.FT_SIZE + 8, 6, rgb=True)
    (root / "potsdam" / "train.txt").write_text("\n".join(names[:W.FT_TRAIN]))
    (root / "potsdam" / "valid.txt").write_text("\n".join(names[W.FT_TRAIN:]))
    for name in ("sota", "sior"):
        names = _write_tree(root / name, W.RUN_TRAIN + W.RUN_VAL, W.RUN_SIZE + 8, 5, rgb=False)
        (root / name / "train.txt").write_text("\n".join(names[:W.RUN_TRAIN]))
        (root / name / "valid.txt").write_text("\n".join(names[W.RUN_TRAIN:]))


def _one_process(init, drop, clip=5.0, steps=2, control=False):
    """`steps` one-process steps on the global batches (TinySeg at `drop`)."""
    plain = fused_mlp.fused_mlp_plain
    fused_mlp.fused_mlp_plain = split_mlp_plain if control else plain
    try:
        state = W.new_state(W.TinySeg(drop), init, clip=clip)
        losses = [float(pretrain_step(state, W.global_batches(i), 0)["loss"])
                  for i in range(steps)]
    finally:
        fused_mlp.fused_mlp_plain = plain
    return losses, W.snapshot(state)


def _jax_loss_and_grads(params, stats):
    """jax.grad of make_pretrain_step's loss on global batch 0, drops at 0."""
    jm = TinyJax(num_classes=W.CLASSES, image_size=W.SIZE)
    b0 = [(x.numpy(), y.numpy().astype(np.int32)) for x, y in W.global_batches(0)]

    def loss_fn(p):
        outs, _ = jm.apply({"params": p, "batch_stats": stats}, [jnp.asarray(x) for x, _ in b0],
                           True, mutable=["batch_stats"])
        return sum(jax_ce(o, jnp.asarray(y)) for o, (_, y) in zip(outs, b0))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), jax_params_to_torch(grads)


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    """Spawn the two ranks, compute the one-process and JAX references while
    they run, and return both sides."""
    assert W.RVSA == {k: v for k, v in TINY_RVSA.items() if k != "drop_path_rate"}
    tmp = tmp_path_factory.mktemp("ddp")
    data, out = tmp / "data", tmp / "out"
    _write_data(data)
    out.mkdir()
    jm = TinyJax(num_classes=W.CLASSES, image_size=W.SIZE)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            [jnp.zeros((1, W.SIZE, W.SIZE, 3))] * 3, True))
    jvars = draw_variables(shapes, 21)
    init = jax_params_to_torch(jvars["params"], jvars["batch_stats"])
    bn_x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 6, 1, 1)).astype(np.float32))
    torch.save({"init": init, "bn_x": bn_x}, tmp / "inputs.pt")
    port = _free_port()
    procs = []
    for r in range(W.WORLD):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(W.WORLD),
                   LOCAL_WORLD_SIZE=str(W.WORLD), MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(TESTS, "_ddp_worker.py"), str(tmp / "inputs.pt"),
             str(data), str(out)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        ref = {}
        ref["drop_losses"], ref["drop"] = _one_process(init, W.DROP)
        _, ref["drop_control"] = _one_process(init, W.DROP, control=True)
        ref["nodrop_losses"], ref["nodrop"] = _one_process(init, 0.0, clip=1e9, steps=1)
        ref["jax_loss"], ref["jax_grads"] = _jax_loss_and_grads(jvars["params"],
                                                                jvars["batch_stats"])
        model = W.TinySeg(W.DROP)
        model.load_state_dict(init, strict=True)
        model.train()
        with torch.no_grad():
            ref["one_image_logits"] = model.forward_one(
                W.global_batches(7, (2, 2, 2))[0][0], 0, torch.Generator().manual_seed(5))
        ref["one_image_stats"] = {k: v for k, v in model.state_dict().items() if "running" in k}
        bn = BatchNorm(6).train()
        ref["bn"] = bn(bn_x)
        ref["bn_stats"] = (bn.running_mean.clone(), bn.running_var.clone())
        loader = DataLoader(W.IndexDataset(23), batch_size=3 * W.WORLD, seed=5, num_threads=2)
        ref["loader"] = [[x[:, 0].tolist() for x, _ in loader] for _ in range(2)]
        model = W.finetune_model()
        trn, val = W.finetune_datasets(str(data))
        run_finetune(W.finetune_config(str(data), str(tmp / "ft_one")), model, trn, val)
        ref["finetune_scores"] = evaluate_simple(model, val, W.FT_CLASSES, False)
        ref["finetune_state"] = model.state_dict()
        logs = []
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(W.WORLD)]
    return dict(ranks=ranks, ref=ref, out=out)


def _dist(got, want, skip=()):
    """rel-L2 over every tensor of two name -> tensor maps."""
    keys = [k for k in want if k not in skip and want[k].is_floating_point()]
    num = sum(float(((got[k].double() - want[k].double()) ** 2).sum()) for k in keys)
    den = sum(float((want[k].double() ** 2).sum()) for k in keys)
    return (num / den) ** 0.5


def test_two_rank_steps_match_one_process(ddp):
    """Two steps, dropout and drop-path 0.1: the losses, and the parameters,
    gradients, AdamW moments and BatchNorm statistics after them, within
    STEP_TOL or 3x the control's distance."""
    ref = ddp["ref"]
    for r in ddp["ranks"]:
        np.testing.assert_allclose(r["drop_losses"], ref["drop_losses"], rtol=STEP_TOL)
    got, want, ctl = ddp["ranks"][0]["drop"], ref["drop"], ref["drop_control"]
    for what in ("state", "grads", "mu", "nu"):
        d, c = _dist(got[what], want[what]), _dist(ctl[what], want[what])
        assert d <= max(STEP_TOL, CONTROL_FACTOR * c), (what, d, c)


def test_batchnorm_statistics_equal_on_both_ranks(ddp):
    a, b = (r["drop"]["state"] for r in ddp["ranks"])
    stats = [k for k in a if "running" in k]
    assert len(stats) > 10
    for k in a:  # the parameters too: every rank applies the same update
        assert torch.equal(a[k], b[k]), k


def test_two_rank_step_matches_jax_with_drops_off(ddp):
    """Drops at 0, no clip: the global loss and every gradient against
    jax.grad of the JAX step's loss on the global batch (the parameters
    with no true gradient held to noise, as test_torch_port_train.py does)."""
    ref = ddp["ref"]
    rank = ddp["ranks"][0]
    assert abs(rank["nodrop_loss"] - ref["jax_loss"]) <= JAX_TOL * abs(ref["jax_loss"])
    np.testing.assert_allclose(rank["nodrop_loss"], ref["nodrop_losses"][0], rtol=STEP_TOL)
    jgrads, pgrads = ref["jax_grads"], rank["nodrop"]["grads"]
    assert set(jgrads) == set(pgrads)
    total = np.sqrt(sum(float((v.double() ** 2).sum()) for v in jgrads.values()))
    for k, v in jgrads.items():
        g, w = pgrads[k].numpy().copy(), v.numpy().copy()
        if k in ZERO_GRAD:
            for a in (g, w):
                assert np.abs(a[ZERO_GRAD[k]]).max() <= 1e-6 * total, k
            g[ZERO_GRAD[k]] = w[ZERO_GRAD[k]] = 0.0
            if not w.any():
                continue
        assert _rel_l2(g, w) <= JAX_TOL, (k, _rel_l2(g, w))


def test_one_image_a_rank_takes_the_global_batchnorm(ddp):
    """Head 0 with one image on each rank: every BatchNorm (the PPM's 1x1
    pool among them, one value a channel on a rank) normalises over both
    images, so each rank's logits are its row of the one-process forward,
    and the running statistics are the one-process ones.  A BatchNorm on
    one 1x1 image a rank is not the one-value branch (output = bias)."""
    ref = ddp["ref"]
    for i, r in enumerate(ddp["ranks"]):
        np.testing.assert_allclose(r["one_image_logits"].numpy(),
                                   ref["one_image_logits"][i:i + 1].numpy(), rtol=1e-5, atol=1e-5)
        for k, v in ref["one_image_stats"].items():
            np.testing.assert_allclose(r["one_image_stats"][k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        np.testing.assert_allclose(r["bn1"].detach().numpy(), ref["bn"][i:i + 1].detach().numpy(),
                                   rtol=1e-6, atol=1e-6)
        assert not torch.allclose(r["bn1"], torch.zeros_like(r["bn1"]))  # not the bias (0)
        for got, want in zip(r["bn1_stats"], ref["bn_stats"]):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)


def test_loader_shards_make_up_the_one_process_batches(ddp):
    """Rank r reads order[r::W]: per step the ranks' batches together are the
    one-process batch of W times their size; every rank counts
    len(dataset) // W // batch steps; an evaluation shard reads every image."""
    ranks, ref = ddp["ranks"], ddp["ref"]
    assert [r["loader_len"] for r in ranks] == [23 // 2 // 3] * 2
    for epoch in range(2):
        steps = list(zip(*(r["loader"][epoch] for r in ranks)))
        assert len(steps) == len(ref["loader"][epoch])
        for parts, want in zip(steps, ref["loader"][epoch]):
            assert sorted(sum(parts, [])) == sorted(want)
            assert list(parts[0]) == want[0::2] and list(parts[1]) == want[1::2]
    assert sorted(sum((sum(r["val_loader"], []) for r in ranks), [])) == list(range(23))


@pytest.mark.parametrize("world", [1, 2, 8])
def test_batch_rounding_matches_jax(world):
    """samrs_tpu/train/pretrain.py:131 / finetune.py:130: max(W, (b // W) * W)."""
    for b in range(0, 130):
        assert data_parallel_batch(b, world) == max(world, (b // world) * world)
    sizes = proportional_batch_sizes(("sota", "sior", "fast"), 96)
    got = {k: data_parallel_batch(v, world) for k, v in sizes.items()}
    assert all(v % world == 0 and v >= world for v in got.values())
    if world == 2:
        assert got == {"sota": 16, "sior": 12, "fast": 64}


def test_two_rank_finetune_epoch_gives_the_one_process_evaluation(ddp):
    """One epoch (2 steps of 2 + 2 images, unaugmented, no dropout: the
    global batch is a permutation of the one-process one), rank 0's
    checkpoints, then the sharded evaluation: the same scores."""
    ref = ddp["ref"]
    for r in ddp["ranks"]:
        for k in ("miou", "mf1", "all_acc"):
            assert r["finetune_scores"][k] == ref["finetune_scores"][k], k
        for k in ("iou", "f1"):
            np.testing.assert_array_equal(r["finetune_scores"][k], ref["finetune_scores"][k])
        # two Adam steps at lr 1e-3 move the coordinates without a true gradient (biases a
        # BatchNorm removes) by up to lr on their rounding noise: held to JAX_TOL
        assert _dist(r["finetune_state"], ref["finetune_state"]) <= JAX_TOL
    assert os.listdir(ddp["out"] / "ft") and sorted(os.listdir(ddp["out"] / "ft")) == [
        "best.pt", "best_encoder.pt", "last.pt", "last_encoder.pt"]


def test_run_pretrain_two_ranks(ddp):
    """2 steps and an evaluation: the same mIoU lines on both ranks,
    checkpoints saved by rank 0 alone, and a resume from ``last`` that
    restores the step and the weights on both."""
    ranks = ddp["ranks"]
    evals = [[ln for ln in r["run_lines"] if ln.startswith(("val[", "iter 2 eval"))]
             for r in ranks]
    assert len(evals[0]) == 3 and evals[0] == evals[1]
    assert ranks[0]["run_saves"] == ["last", "best"] and ranks[1]["run_saves"] == []
    for r in ranks:
        assert r["run_step"] == 2 and r["resume_step"] == 2 and r["resume_same"]
        assert any("per-dataset batch sizes: {'sota': 4, 'sior': 2} on 2 rank(s)" in ln
                   for ln in r["run_lines"]), r["run_lines"][:3]


def test_refusals(ddp):
    for r in ddp["ranks"]:
        assert r["backend"] == "gloo" and r["world"] == 2
        assert "mesh (4,) != 2 ranks" in r["mesh_shape_error"]
        for key in ("m2f_step_error", "m2f_run_error"):
            assert "ROADMAP.md" in r[key] and "Mask2Former" in r[key]


# ------------------------------------------------------- logging_utils ----


def test_only_rank_zero_writes_log_txt(tmp_path, monkeypatch):
    for rank in (1, 0):
        monkeypatch.setenv("RANK", str(rank))
        name = f"samrs_tpu_torch.test_rank{rank}"
        log = logging_utils.setup_logger(name, str(tmp_path / f"r{rank}"))
        log.info("hello")
        for h in log.handlers:
            h.flush()
        assert logging_utils.is_main_process() == (rank == 0)
        assert os.path.exists(tmp_path / f"r{rank}" / "log.txt") == (rank == 0)
        for h in list(log.handlers):
            log.removeHandler(h)
            h.close()
    assert "hello" in (tmp_path / "r0" / "log.txt").read_text()


def test_log_metrics_line_matches_jax(caplog):
    metrics = {"loss": torch.tensor(1.234567891), "lr": 6e-5, "tag": "x", "n": 3,
               "np": np.float32(0.5)}
    for mod, name in ((jax_logging, "jaxside"), (logging_utils, "portside")):
        with caplog.at_level(logging.INFO, logger=name):
            mod.log_metrics(logging.getLogger(name), 7, {**metrics, "loss": 1.234567891}
                            if mod is jax_logging else metrics)
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 2 and lines[0] == lines[1] == \
        "step 7 loss=1.2346 lr=6e-05 tag=x n=3 np=0.5"


def test_seed_everything_folds_the_rank(monkeypatch):
    seeds = {}
    for rank in (0, 1, 0):
        monkeypatch.setenv("RANK", str(rank))
        s = logging_utils.seed_everything(2023)
        a = (np.random.rand(), torch.rand(()).item())
        assert seeds.setdefault(rank, (s, a)) == (s, a)  # reproducible
    assert seeds[0][0] != seeds[1][0]
    assert seeds[0][1][1] != seeds[1][1][1]  # torch: the rank folded in
    jax_logging.seed_everything(2023)  # numpy seeded with the seed itself, on every rank
    assert seeds[0][1][0] == seeds[1][1][0] == np.random.rand()
