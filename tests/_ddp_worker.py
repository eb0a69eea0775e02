"""One rank of tests/test_torch_port_ddp.py: two of these run together under
a gloo process group on the CPU (RANK / WORLD_SIZE / MASTER_ADDR /
MASTER_PORT in the environment, as torchrun sets them), each on its rows
of the same global batches (UperNet and Mask2Former pretraining, finetuning)
or its share of the token rows (ring attention, the sequence-parallel SAM
encoder), and write what they saw to ``<out>/rank{r}.pt``.

    python tests/_ddp_worker.py <inputs.pt> <data dir> <out dir>

Imports torch and the port only.  The tiny models and the batches are built
here, and imported from here by the test, so both sides build the same.
"""

import os
import sys

import numpy as np
import torch
from torch import nn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from samrs_tpu_torch.core.config import (DataConfig, FinetuneConfig,  # noqa: E402
                                         OptimConfig, PretrainConfig)
from samrs_tpu_torch.core.mesh import init_data_mesh, sharded  # noqa: E402
from samrs_tpu_torch.data.datasets import (DataLoader, ISPRSDataset,  # noqa: E402
                                           SegmentationDataset)
from samrs_tpu_torch.data.transforms import EvalAugment, TrainAugment  # noqa: E402
from samrs_tpu_torch.kernels import ring_attention  # noqa: E402
from samrs_tpu_torch.sam.image_encoder import ImageEncoderViT  # noqa: E402
from samrs_tpu_torch.seg.backbones.rvsa import ViTRVSA  # noqa: E402
from samrs_tpu_torch.seg.backbones.vit import ViTSeg  # noqa: E402
from samrs_tpu_torch.seg.decoders.blocks import BatchNorm  # noqa: E402
from samrs_tpu_torch.seg.decoders.mask2former import (Mask2FormerDecoder,  # noqa: E402
                                                      Mask2FormerHead)
from samrs_tpu_torch.seg.decoders.upernet import UPerHead  # noqa: E402
from samrs_tpu_torch.seg.frameworks import (MultiHeadMask2FormerModel,  # noqa: E402
                                            MultiHeadSegModel, SegHead, SegModel,
                                            init_mask2former, init_parameters)
from samrs_tpu_torch.train import optim  # noqa: E402
from samrs_tpu_torch.train.finetune import evaluate_simple, run_finetune  # noqa: E402
from samrs_tpu_torch.train.pretrain import run_pretrain  # noqa: E402
from samrs_tpu_torch.train.trainer import (TrainState, pretrain_step,  # noqa: E402
                                           pretrain_step_mask2former)

WORLD = 2
SIZE = 80                  # the tiny RVSA's 5x5 tokens, padded to one 7x7 window
CLASSES = (3, 4, 5)
GLOBAL_BATCH = (4, 4, 6)   # per head; 2 / 2 / 3 a rank
RVSA = dict(embed_dim=32, depth=3, num_heads=2, window_size=7, interval=3,
            out_indices=(0, 1, 2, 2), use_abs_pos_emb=False)  # test_torch_port_seg's TINY_RVSA
DROP = 0.1                 # the pretraining defaults' head dropout and drop-path
LR, WARMUP, TOTAL, OFFSET = 6e-5, 2, 20, 5   # the schedule past its warmup: lr > 0
FT_SIZE, FT_CLASSES, FT_TRAIN, FT_VAL, FT_BATCH = 32, 6, 8, 5, 4
RUN_SIZE, RUN_TRAIN, RUN_VAL = 32, 12, 5
# Mask2Former: test_torch_port_mask2former.py's tiny decoder on the RVSA trunk
M2F_DEC = dict(embed_dim=32, num_queries=8, num_decoder_layers=3, num_heads=2)
M2F_CLASSES = (3, 4, 5)
M2F_BATCH = (2, 2, 4)      # per head; 1 / 1 / 2 a rank
M2F_POINTS = 16
# the step cases: the batch seeds of their steps, num_points, head 0's rank-1 image all ignored.
# Their batches sit on no kink of the step's gradient: the RVSA trunk's sampling (K8's
# coordinate derivative is one-sided at integer coordinates) makes it jump on about half
# the seeds, where the inputs scaled by 1 + 1e-7 move it by 1e-4 to 4e-2, and the two ranks'
# matmuls (the batch blocked otherwise) land on either side; test_torch_port_ddp.py checks
# each case's batches against that
M2F_CASES = {"exact": ((6, 8), None, False), "point": ((9,), M2F_POINTS, False),
             "ignore": ((10,), None, True)}
M2F_JAX_SEED = 12          # the point step on JAX's draws
# run_pretrain's global batch: 4 / 3 images a head and rank (at 32^2 the pixel decoder's c4 is
# 1 x 1, where torch's GroupNorm refuses a batch of one value a group in training)
M2F_RUN_BATCH = 16
# ring attention: tests/test_ring_attention.py's shapes; its tiny SAM encoder
RING_B, RING_N, RING_D, RING_HW = 2, 64, 16, (16, 4)
SP_ENCODER = dict(img_size=128, patch_size=16, embed_dim=32, depth=2, num_heads=2, out_chans=16,
                  window_size=4, global_attn_indexes=(1,))
SP_KNOBS = dict(window_attn_impl="pallas", mlp_impl="xla")  # the JAX encoder's defaults


class TinySeg(MultiHeadSegModel):
    """MultiHeadSegModel with the width-32 RVSA trunk (two RVSA blocks, one
    full), a 16-wide UperNet and 1x1 heads; dropout and drop-path at `drop`."""

    def __init__(self, drop=0.0, num_classes=CLASSES, size=SIZE):
        nn.Module.__init__(self)
        self.use_kernels = True
        self.num_classes = tuple(num_classes)
        self.encoder = ViTRVSA(img_size=size, drop_path_rate=drop, **RVSA)
        self.seg_decoder = UPerHead(self.encoder.out_channels[1:], channels=16)
        self.heads = nn.ModuleList(SegHead(16, nc, 1, dropout=drop) for nc in self.num_classes)


class TinyFinetune(SegModel):
    """SegModel with a width-32 ViT, a 16-wide UperNet and no dropout: the
    loader's global batch is the ranks' shards in rank order, a permutation
    of the one-process batch, so a dropout row would fall on another image
    (the JAX loader shards alike)."""

    def __init__(self):
        nn.Module.__init__(self)
        self.use_kernels = True
        self.num_classes = FT_CLASSES
        self.encoder = ViTSeg(img_size=FT_SIZE, embed_dim=32, depth=2, num_heads=2,
                              drop_path_rate=0.0)
        self.seg_decoder = UPerHead(self.encoder.out_channels[1:], channels=16)
        self.head = SegHead(16, FT_CLASSES, 1, dropout=0.0)


class TinyM2F(MultiHeadMask2FormerModel):
    """MultiHeadMask2FormerModel with the width-32 RVSA trunk and the tiny
    decoder (embed 32, 8 queries, 3 layers, 2 heads); drop-path at `drop`."""

    def __init__(self, drop=0.0, num_classes=M2F_CLASSES, size=SIZE):
        nn.Module.__init__(self)
        self.backbone, self.decoder, self.image_size = "vit_b_rvsa", "mask2former", size
        self.use_kernels = True
        self.num_classes = tuple(num_classes)
        self.encoder = ViTRVSA(img_size=size, drop_path_rate=drop, **RVSA)
        self.seg_decoder = Mask2FormerDecoder((32,) * 4, **M2F_DEC)
        self.heads = nn.ModuleList(Mask2FormerHead(32, nc) for nc in self.num_classes)


def m2f_batches(seed, ignore_rank1_head0=False):
    """One (x, y) per head (the last class absent, some pixels ignored);
    optionally head 0's rank-1 image all ignored."""
    rng = np.random.default_rng(100 + seed)
    out = []
    for b, nc in zip(M2F_BATCH, M2F_CLASSES):
        x = rng.normal(size=(b, SIZE, SIZE, 3)).astype(np.float32)
        y = rng.integers(0, nc - 1, (b, SIZE, SIZE)).astype(np.int64)
        y[:, :7] = 255
        out.append((torch.from_numpy(x), torch.from_numpy(y)))
    if ignore_rank1_head0:
        out[0][1][out[0][1].shape[0] // WORLD:] = 255
    return out


def array_draws(arrays):
    """A ``draw`` replaying fixed uniforms: arrays["kind:layer"] of the shape asked."""
    def draw(kind, layer, shape):
        a = arrays[f"{kind}:{layer}"]
        assert tuple(a.shape) == tuple(shape), (kind, layer, a.shape, shape)
        return a.clone()
    return draw


def global_batches(seed, sizes=GLOBAL_BATCH):
    """One (x, y) per head: seeded images and labels, some pixels ignored."""
    rng = np.random.default_rng(seed)
    out = []
    for b, nc in zip(sizes, CLASSES):
        x = rng.normal(size=(b, SIZE, SIZE, 3)).astype(np.float32)
        y = rng.integers(0, nc, (b, SIZE, SIZE)).astype(np.int64)
        y[:, :7 + b] = 255
        out.append((torch.from_numpy(x), torch.from_numpy(y)))
    return out


def rows(batches, rank, world=WORLD):
    """Rank `rank`'s rows of each global batch (the ranks' batches in rank order)."""
    return [(x[rank * (x.shape[0] // world):(rank + 1) * (x.shape[0] // world)],
             y[rank * (y.shape[0] // world):(rank + 1) * (y.shape[0] // world)])
            for x, y in batches]


def new_state(model, init, mesh=None, clip=5.0):
    model.load_state_dict(init, strict=True)
    sched = optim.warmup_cosine_schedule(LR, TOTAL, WARMUP)
    opt = optim.Optimizer(model, lambda s: sched(s + OFFSET), weight_decay=0.05, grad_clip=clip,
                          layer_decay=0.9, num_layers=3)
    return TrainState(0, model, opt, mesh)


def snapshot(state):
    """Parameters and buffers, gradients and both AdamW moments, by name."""
    model, opt = state.model, state.optimizer
    names = {p: n for n, p in model.named_parameters()}
    return dict(state={k: v.clone() for k, v in model.state_dict().items()},
                grads={n: p.grad.clone() for n, p in model.named_parameters()},
                mu={names[p]: s["exp_avg"].clone() for p, s in opt.opt.state.items()},
                nu={names[p]: s["exp_avg_sq"].clone() for p, s in opt.opt.state.items()})


class IndexDataset:
    """Item i is (i, i) as arrays: the loader's order made visible."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((1,), i, np.int64), np.full((1,), i, np.int64)


def finetune_config(root, ckpt_dir):
    return FinetuneConfig(dataset="potsdam", epochs=1, image_size=FT_SIZE, batch_size=FT_BATCH,
                          seed=3, device="cpu", ckpt_dir=ckpt_dir,
                          data=DataConfig(root=root, num_workers=1, val_images=FT_VAL),
                          optim=OptimConfig(lr=1e-3, warmup_iters=1))


def finetune_datasets(root):
    base = os.path.join(root, "potsdam")
    paths = (base, os.path.join(base, "images"), os.path.join(base, "labels"))
    # the training images unaugmented: a process's augmentation draws follow its own
    # share of the items, so augmented batches differ between two ranks and one process
    return (ISPRSDataset(*paths, split="trn", transform=EvalAugment(FT_SIZE)),
            ISPRSDataset(*paths, split="val", transform=EvalAugment(FT_SIZE), val_images=FT_VAL))


def finetune_model():
    model = TinyFinetune()
    init_parameters(model, torch.Generator().manual_seed(11))
    return model


def pretrain_config(root, ckpt_dir, batch_size=8, **kw):
    return PretrainConfig(total_iters=2, eval_interval=2, seed=0, device="cpu",
                          data=DataConfig(root=root, datasets=("sota", "sior"),
                                          image_size=RUN_SIZE, batch_size=batch_size,
                                          num_workers=1, val_images=RUN_VAL),
                          optim=OptimConfig(lr=1e-3, warmup_iters=1), ckpt_dir=ckpt_dir, **kw)


def pretrain_datasets(root):
    out = {}
    for split, aug in (("trn", TrainAugment(RUN_SIZE, seed=0)), ("val", EvalAugment(RUN_SIZE))):
        out[split] = {n: SegmentationDataset(os.path.join(root, n), os.path.join(root, n, "images"),
                                             os.path.join(root, n, "labels"), split=split,
                                             transform=aug, val_images=RUN_VAL)
                      for n in ("sota", "sior")}
    return out


def pretrain_model():
    model = TinySeg(num_classes=(18, 20), size=RUN_SIZE)
    init_parameters(model, torch.Generator().manual_seed(12))
    return model


def pretrain_m2f_model():
    model = TinyM2F(num_classes=(18, 20), size=RUN_SIZE)
    gen = torch.Generator().manual_seed(13)
    init_parameters(model, gen)
    init_mask2former(model, gen)
    return model


def run_and_resume(cfg, make_model, ds, saves, lines):
    """run_pretrain, then a resume from ``last``: the step counts, the saves,
    the log lines and whether the resume restored the weights."""
    out = {}
    model = make_model()
    state = run_pretrain(cfg, model, ds["trn"], ds["val"])
    out["run_step"], out["run_saves"] = state.step, list(saves)
    out["run_lines"] = list(lines)
    trained = {k: v.clone() for k, v in model.state_dict().items()}
    resumed = make_model()
    cfg2 = PretrainConfig(**{**cfg.__dict__, "resume": "last"})
    out["resume_step"] = run_pretrain(cfg2, resumed, ds["trn"], ds["val"]).step
    out["resume_same"] = all(torch.equal(resumed.state_dict()[k], v) for k, v in trained.items())
    saves.clear()
    lines.clear()
    return out, trained


def m2f_steps(init, case, mesh=None, scale=1.0):
    """The steps of M2F_CASES[case] with drop-path on, on this rank's rows of
    the global batches (all of them without a mesh), the images scaled by
    `scale`: the losses and the snapshot."""
    seeds, points, ignore = M2F_CASES[case]
    state = new_state(TinyM2F(DROP), init, mesh)
    losses = []
    for seed in seeds:
        batches = [(x * scale, y) for x, y in m2f_batches(seed, ignore)]
        batches = batches if mesh is None else rows(batches, mesh.rank)
        losses.append(float(pretrain_step_mask2former(state, batches, 0, M2F_CLASSES,
                                                      points)["loss"]))
    return losses, snapshot(state)


def m2f_part(inputs, mesh):
    """The Mask2Former step on this rank's rows: M2F_CASES (two exact steps,
    one point step, one exact step where head 0's rank-1 image is all
    ignored), then one point step on JAX's draws (drop-path off)."""
    r, out = mesh.rank, {}
    for case in M2F_CASES:
        out[case + "_losses"], out[case] = m2f_steps(inputs["m2f_init"], case, mesh)
    state = new_state(TinyM2F(0.0), inputs["m2f_init"], mesh)
    met = pretrain_step_mask2former(state, rows(m2f_batches(M2F_JAX_SEED), r), 0, M2F_CLASSES,
                                    M2F_POINTS, [array_draws(a) for a in inputs["m2f_draws"]])
    out["jax_draw_losses"] = [float(met[f"loss_{h}"]) for h in range(3)]
    return out


def ring_part(inputs, mesh):
    """Ring attention over the two ranks: sp_attention without and with a
    bias, ring_attention on this rank's chunks, sp_flash_attention_relpos,
    and the tiny SAM encoder with its global block split among the ranks."""
    r, out = mesh.rank, {}
    q, k, v, bias, Rh, Rw = (inputs["ring"][n] for n in ("q", "k", "v", "bias", "Rh", "Rw"))
    scale = RING_D ** -0.5
    n = RING_N // WORLD
    local = slice(r * n, (r + 1) * n)
    with torch.no_grad():
        out["sp"] = ring_attention.sp_attention(q, k, v, mesh, scale)
        out["sp_bias"] = ring_attention.sp_attention(q, k, v, mesh, scale, bias)
        out["ring_bias"] = ring_attention.ring_attention(q[:, local], k[:, local], v[:, local],
                                                         mesh, scale, bias[:, local])
        out["sp_relpos"] = ring_attention.sp_flash_attention_relpos(q, k, v, Rh, Rw, RING_HW,
                                                                    scale, mesh)
        enc = ImageEncoderViT(**SP_ENCODER, **SP_KNOBS, sp_mesh=mesh)
        enc.load_state_dict(inputs["sp_state"], strict=True)
        out["sp_encoder"] = enc(inputs["sp_x"])
    out["transport"] = ring_attention.transport(mesh, "cpu")
    try:
        ring_attention.sp_flash_attention_relpos(q, k, v, Rh[:1, :1], Rh[:RING_N], (1, RING_N),
                                                 scale, mesh)
    except ValueError as e:
        out["rows_error"] = str(e)
    return out


def main(inputs_path, data_dir, out_dir):
    torch.set_num_threads(2)
    inputs = torch.load(inputs_path, weights_only=True)
    out = {}
    try:
        init_data_mesh((4,), "cpu")
    except ValueError as e:
        out["mesh_shape_error"] = str(e)
    mesh = init_data_mesh((-1,), "cpu")
    r = mesh.rank
    out["backend"], out["world"] = mesh.backend, mesh.world

    # two steps with dropout and drop-path on, from the drawn init
    state = new_state(TinySeg(DROP), inputs["init"], mesh)
    out["drop_losses"] = [float(pretrain_step(state, rows(global_batches(i), r), 0)["loss"])
                          for i in range(2)]
    out["drop"] = snapshot(state)
    # one step with the drops at 0 and no clip: the raw gradients, for JAX
    state = new_state(TinySeg(0.0), inputs["init"], mesh, clip=1e9)
    out["nodrop_loss"] = float(pretrain_step(state, rows(global_batches(0), r), 0)["loss"])
    out["nodrop"] = snapshot(state)

    # one image a rank on head 0: the train-mode forward over the global batch of 2
    model = TinySeg(DROP)
    model.load_state_dict(inputs["init"], strict=True)
    model.train()
    x = global_batches(7, (2, 2, 2))[0][0][r:r + 1]
    with torch.no_grad(), sharded(mesh):
        out["one_image_logits"] = model.forward_one(x, 0, torch.Generator().manual_seed(5))
    out["one_image_stats"] = {k: v.clone() for k, v in model.state_dict().items()
                              if "running" in k}
    bn = BatchNorm(6).train()
    with sharded(mesh):
        out["bn1"] = bn(inputs["bn_x"][r:r + 1])
    out["bn1_stats"] = (bn.running_mean.clone(), bn.running_var.clone())

    # the loader's shards over two epochs
    loader = DataLoader(IndexDataset(23), batch_size=3, seed=5, process_index=r,
                        process_count=WORLD, num_threads=2)
    out["loader_len"] = len(loader)
    out["loader"] = [[x[:, 0].tolist() for x, _ in loader] for _ in range(2)]
    val = DataLoader(IndexDataset(23), batch_size=4, shuffle=False, drop_last=False,
                     process_index=r, process_count=WORLD)
    out["val_loader"] = [x[:, 0].tolist() for x, _ in val]

    # a finetune epoch over the two ranks, then its evaluation
    model = finetune_model()
    trn, val = finetune_datasets(data_dir)
    run_finetune(finetune_config(data_dir, os.path.join(out_dir, "ft")), model, trn, val)
    out["finetune_scores"] = evaluate_simple(model, val, FT_CLASSES, False, mesh=mesh)
    out["finetune_state"] = {k: v.clone() for k, v in model.state_dict().items()}

    # run_pretrain over the two ranks, UperNet and Mask2Former: 2 steps, an eval,
    # checkpoints; then a resume
    ds = pretrain_datasets(data_dir)
    saves = []
    import samrs_tpu_torch.train.pretrain as pretrain_mod
    real_save = pretrain_mod.save_train_state
    pretrain_mod.save_train_state = lambda *a, **k: (saves.append(a[4]), real_save(*a, **k))
    import logging
    lines = []
    handler = logging.Handler()
    handler.emit = lambda rec: lines.append(rec.getMessage())
    logging.getLogger("samrs_tpu_torch.pretrain").addHandler(handler)
    logging.getLogger("samrs_tpu_torch.pretrain").setLevel(logging.INFO)
    run, out["run_state"] = run_and_resume(
        pretrain_config(data_dir, os.path.join(out_dir, "pretrain")), pretrain_model, ds, saves,
        lines)
    out.update(run)
    out["m2f_run"], _ = run_and_resume(
        pretrain_config(data_dir, os.path.join(out_dir, "pretrain_m2f"), decoder="mask2former",
                        m2f_num_points=M2F_POINTS, batch_size=M2F_RUN_BATCH), pretrain_m2f_model,
        ds, saves, lines)
    pretrain_mod.save_train_state = real_save

    out["m2f"] = m2f_part(inputs, mesh)
    out["ring"] = ring_part(inputs, mesh)
    torch.save(out, os.path.join(out_dir, f"rank{r}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:4])
