"""Configuration dataclasses.

Replaces the reference's argparse + post-parse ``args`` mutation
(``fusion_train.py:510-542`` and the dataset branches at ``:550-654``) with a
single typed config surface.  Every reference CLI flag has a corresponding
field; defects in the reference knob surface are fixed here and noted:

- ``Condition_G_Variance`` was ignored by the shipped loader (low noise was
  hard-coded to sigma=0 and high noise to sigma=0.5,
  ``code/data_harvard.py:716-728,769-783``).  Here ``noise.gaussian_low`` /
  ``noise.gaussian_high`` are real, honored knobs with the as-executed
  defaults.
- The salt-and-pepper branches referenced undefined ``*_low/_high``
  attributes (crash); ``noise.salt_pepper_low/high`` make them real.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    """Dual-view input-corruption config (the reference's robustness axis).

    Mirrors ``--condition``, ``--condition_name``, ``--Condition_SP_Variance``,
    ``--Condition_G_Variance`` (``fusion_train.py:534-537``) but with separate,
    honored low/high knobs (reference defect ledger #6).
    """

    condition: str = "noise"  # "noise" | "normal"
    condition_name: str = "Gaussian"  # "Gaussian" | "SaltPepper" | "All"
    # As-executed reference values: low view is clean, high view sigma=0.5.
    gaussian_low: float = 0.0
    gaussian_high: float = 0.5
    salt_pepper_low: float = 0.0
    salt_pepper_high: float = 0.005


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset layout and preprocessing (reference L1, ``code/data_harvard.py``)."""

    dataset: str = "synthetic"  # "synthetic" | "dr2" | "glu2" (GAMMA-style dirs)
    data_path: str = ""
    label_file: str = ""
    fundus_size: int = 384  # transformer path (``code/data_harvard.py:686``)
    oct_size: Tuple[int, int, int] = (96, 96, 96)  # (D, H, W) (``:688``)
    num_classes: int = 2
    folds: int = 5
    fold: int = 0
    split_seed: int = 10  # KFold(shuffle=True, random_state=10) parity
    batch_size: int = 32
    eval_batch_size: int = 16
    drop_last: bool = True
    num_synthetic_samples: int = 64
    # Train-time augmentations (``code/data_harvard.py:621-634``).
    color_jitter_prob: float = 0.8
    color_jitter_strength: Tuple[float, float, float, float] = (0.2, 0.2, 0.2, 0.1)
    grayscale_prob: float = 0.2
    hflip_prob: float = 0.5
    noise: NoiseConfig = dataclasses.field(default_factory=NoiseConfig)
    seed: int = 11  # reference ``args.seed_idx = 11``; here it keys per-sample PRNG
    # Build the dual noise views on-device inside the jitted step (half the
    # host->device transfer, no host noise cost).  False = host path with
    # per-view augmentation draws (full reference parity).
    device_noise: bool = False
    # Ship clean batches as uint8 and normalize on device (4x less
    # host->device traffic; source images are 8-bit anyway).  Only applies
    # with device_noise.
    uint8_transport: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """EDRL model hyperparameters (``fusion_net.py:770-836``)."""

    model_name: str = "MedFusion"
    num_classes: int = 2  # shipped model is binary (``fusion_net.py:787,930``)
    fundus_embed_dim: int = 1024  # Swin final-stage dim (``fusion_net.py:783``)
    oct_embed_dim: int = 768  # 3-D ViT dim (``fusion_net.py:784``)
    fundus_tokens: int = 144  # 12x12 grid at 384^2 (``fusion_net.py:95``)
    oct_tokens: int = 216  # 6^3 grid at 96^3 patch16 (``fusion_net.py:96``)
    z_dim: int = 256  # EPRL latent (``fusion_net.py:64-80``)
    sample_num: int = 800  # proxy samples (``fusion_net.py:790``)
    proxy_topk: int = 100  # ``self_topk`` (``fusion_net.py:199,236``)
    pseudo_label_threshold: float = 0.5  # (``fusion_net.py:153``)
    common_ratio: float = 0.5  # DILR split (``fusion_net.py:581``)
    bt_off_diag_weight: float = 0.0051  # (``fusion_net.py:674-675``)
    num_heads: int = 8
    # The reference's ``dropout = 0.25`` (``fusion_net.py:782``) feeds ONLY
    # its constructed-but-dead fundus/oct TransformerEncoders (ledger #12);
    # the live EDRL dropouts are hard-coded in their modules for parity
    # (EPRL 0.2, ``fusion_net.py:85-96``; DILR's AttentionModel has none,
    # ``fusion_net.py:550-578``).  This field is intentionally NOT threaded
    # anywhere — changing it changes nothing, matching the reference.
    dropout: float = 0.25
    label_smoothing: float = 0.1  # (``fusion_net.py:931``)
    # Loss weights, as executed (``fusion_net.py:870-879``; ledger #3).
    kl_weight: float = 0.01
    proxy_weight_train: float = 0.3
    proxy_weight_eval: float = 0.8
    dilr_weight: float = 0.001
    # Masked-expert PoE semantics for missing-modality eval: False (default)
    # zeroes the absent expert's alpha without renormalizing (the reference's
    # implied behavior, fusion_net.py:32-39); True renormalizes surviving
    # alphas to sum 1 so the single-expert limit is exactly mu_k + var_k.
    # Checked choice: tests/test_models.py::TestPoEMaskRenormalization
    # probes masked accuracy under both on a trained tiny model.
    poe_renormalize_mask: bool = False
    # Backbone architecture knobs.  The head split (head_dim 128 at every
    # Swin stage, 6 ViT heads) keeps the reference's token/dim contract
    # [B, 144, 1024] / [B, 216, 768]; use swin_heads=(4, 8, 16, 32) and
    # vit3d_heads=12 for literal Swin-B / ViT-Base.
    swin_depths: Tuple[int, ...] = (2, 2, 6, 2)
    swin_heads: Tuple[int, ...] = (1, 2, 4, 8)
    swin_embed_dim: int = 128
    swin_window: int = 12
    vit3d_depth: int = 12
    vit3d_heads: int = 6
    vit3d_patch: int = 16
    # Compute precision: bf16 activations/matmuls with f32 params & reductions.
    use_bfloat16: bool = True
    remat: bool = False  # jax.checkpoint over backbone blocks
    # Remat only the window attention (its [G, N, N] f32 scores dominate
    # activation memory).
    remat_attention: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer knobs (``fusion_train.py:506-544,747-750``)."""

    mode: str = "train&test"  # "train" | "test" | "train&test"
    lr: float = 1e-5  # Run_fusion.sh value
    # Linear LR warmup over this many optimizer steps (0 = the reference's
    # constant-lr behavior).  DEFAULT 100: a deliberate deviation from the
    # reference (PARITY.md), because constant lr leaves the full-EDRL
    # composite loss on its init plateau for entire training budgets on
    # some seeds — the 75-epoch fusion-protocol study measured seed 1
    # never descending (val 0.562, train loss 2.01) while 100 warmup
    # steps rescue it (val 0.750, train loss 1.80) and leave converging
    # seeds within seed noise (warmup seeds 0-3 mean 0.73 vs 0.67
    # without; ABLATION_FUSION_WARMUP.md).  Implemented as a
    # multiplicative factor downstream of the injected base lr, so the
    # plateau schedule's lr mutation composes.  Set 0 for strict
    # reference-optimizer parity.
    warmup_steps: int = 100
    # Global-norm gradient clipping before the optimizer (0 = off, the
    # reference's behavior).  Framework extension: standard stability knob,
    # applied to raw gradients upstream of weight decay (torch idiom).
    grad_clip_norm: float = 0.0
    weight_decay: float = 1e-6  # Adam weight_decay (``fusion_train.py:747``)
    start_epoch: int = 1
    end_epochs: int = 200
    seed: int = 0
    mmd_kernel_mul: float = 2.0
    mmd_kernel_num: int = 5
    # Ablation knob: weight on the MK-MMD self-distillation term.  0 skips
    # the high-noise-view forward entirely (the term is the only consumer of
    # it, ``fusion_train.py:194``), halving step FLOPs — used by the hard
    # synthetic ablation study to measure what the distillation buys.
    mmd_weight: float = 1.0
    # JS-divergence logit distillation between the two noise views — present
    # but commented out in the reference (``fusion_train.py:203-207``); 0.0
    # reproduces as-executed behavior.
    js_distillation_weight: float = 0.0
    # Train-loop dispatch amortization: run this many steps per jitted call
    # as one on-device lax.scan (0/1 = per-batch dispatch), at the cost of
    # holding scan_batches x batch of inputs in device memory.  PRNG/step
    # semantics are identical to per-batch dispatch.
    scan_batches: int = 0
    checkpoint_dir: str = "checkpoint"
    log_dir: str = "log"
    # Keep an ``epoch_{N}`` checkpoint every N epochs (0 = best-only).
    # Enables ``--test_epoch`` to evaluate a specific historical epoch like
    # the reference's per-epoch .pth files (``fusion_train.py:517``).
    save_every: int = 0
    # Rolling ``latest`` checkpoint every N epochs (0 = off) for preemption
    # resume; writes overlap training (async checkpointer).  With --resume,
    # the CLI restores ``latest`` and continues from the epoch derived from
    # the checkpointed step counter (exact: deterministic per-epoch loader
    # shuffles + step-folded PRNG make the resumed run step-identical to an
    # uninterrupted one; only the host-side plateau tracker restarts).  The
    # reference's --start_epoch reloads nothing (SURVEY section 5.4).
    save_latest_every: int = 0
    resume: bool = False
    # End-of-run loss/accuracy curve jpgs, written here when non-empty
    # (reference ``loss_plot``/``metrics_plot`` to results/plot/,
    # ``fusion_train.py:65-76,120-135,771-772``).
    plot_dir: str = ""
    # Every N epochs dump the EPRL proxy Student-t distribution PDFs to
    # ``plot_dir`` (0 = off).  The reference's equivalent
    # (``fusion_net.py:852-868``) was defined but had no call site; 10 was
    # its evident intended cadence.
    student_t_every: int = 0
    name: str = "checkpoint_0.3"  # reference --name
    # Plateau LR schedule existed but was never stepped in the reference
    # (``fusion_train.py:748``, ledger #10); off by default for parity.
    use_plateau_schedule: bool = False
    plateau_factor: float = 0.1
    plateau_patience: int = 10
    # What the plateau tracker watches.  "loss" mirrors the reference's
    # ReduceLROnPlateau(mode=min) construction, but note the eval loss is
    # dominated by the 0.8-weighted proxy term exp(-pos+neg)
    # (``fusion_net.py:870-879``; magnitudes ~60 vs CE ~0.7), so a
    # loss-driven schedule follows proxy geometry, not CE.  The reference
    # never stepped its scheduler and so never faced this interaction;
    # "accuracy" (mode=max on val accuracy) is the recommended setting when
    # the schedule is actually used.
    plateau_metric: str = "loss"  # "loss" | "accuracy"
    # Parallelism.
    data_axis: str = "data"
    model_axis: str = "model"
    num_data_shards: int = 1
    num_model_shards: int = 1
    # ZeRO-1: shard Adam's moment buffers over the data axis (exact — the
    # Adam update is elementwise; GSPMD inserts reduce-scatter/all-gather).
    # Cuts per-chip optimizer-state bytes ~len(data axis); only meaningful
    # under a multi-device mesh.
    zero1: bool = False
    log_every: int = 10


@dataclasses.dataclass(frozen=True)
class EDRLConfig:
    """Top-level config bundle threaded through the framework."""

    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)

    def replace(self, **kw) -> "EDRLConfig":
        return dataclasses.replace(self, **kw)


def tiny_test_config(batch_size: int = 4) -> EDRLConfig:
    """A small config for unit tests and CPU smoke runs.

    Shrinks images, token counts, and sample counts while keeping every
    architectural mechanism (EPRL proxies, PoE, DILR split, dual noise views)
    active.
    """
    data = DataConfig(
        dataset="synthetic",
        fundus_size=64,
        oct_size=(32, 32, 32),
        batch_size=batch_size,
        eval_batch_size=batch_size,
        num_synthetic_samples=4 * batch_size,
    )
    model = ModelConfig(
        swin_depths=(1, 1),
        swin_heads=(2, 4),
        swin_embed_dim=32,
        swin_window=4,
        vit3d_depth=2,
        vit3d_heads=4,
        vit3d_patch=8,
        fundus_embed_dim=64,
        oct_embed_dim=48,
        fundus_tokens=64,   # (64/4/2)^2 = 8^2
        oct_tokens=64,      # (32/8)^3 = 4^3
        z_dim=32,
        sample_num=16,
        proxy_topk=8,
        num_heads=4,
        use_bfloat16=False,
        remat_attention=False,
    )
    # warmup_steps=0: tiny tests train for < 100 steps and assert loss
    # movement — the flagship warmup default would scale their lr to ~0.
    train = TrainConfig(lr=1e-3, end_epochs=2, warmup_steps=0)
    return EDRLConfig(data=data, model=model, train=train)
