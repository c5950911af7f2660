"""MedFusion — the flagship EDRL network.

Rebuild of ``MedFusion`` (``fusion_net.py:770-952``): Swin-2D fundus backbone
and 3-D ViT OCT backbone feed per-modality EPRL modules; the proxy Gaussians
fuse through a deterministic PoE into a global vector; DILR disentangles
common/unique feature blocks; a small MLP head grades the disease.

Loss composition (as-executed weights, defect ledger #3):
``CE(label-smoothed 0.1) + 0.01 KL(fundus) + 0.01 KL(oct)
+ w_proxy (proxy_f + proxy_o) + 0.001 loss_DILR`` with ``w_proxy`` 0.3 in
train / 0.8 in eval (``fusion_net.py:870-879,942-948``).  The eval entropy
term stays disabled (its line is commented out in the reference, ledger #4),
but the entropy value is returned for observability.

Dead reference weight intentionally not ported (ledger #12): ``PID``,
``MIEstimator``/``CLUB`` on the active path, ``fundus_transformer``,
``oct_transformer``, ``logit_fc``, ``MIAttention_fusion`` — all constructed
but never used by the executed forward.  The CLUB math lives in
``edrl.ops.club`` for ablations.

Defect ledger #1: the reference's ``self.gaussian_noise(...)`` call with an
undefined ``dim`` (``fusion_net.py:905-906``) would raise on every forward;
the guided features actually come from ``mu + rand_like * sigma``
(``:907-910``) — only that path is rebuilt.  ``torch.rand_like`` is uniform
[0, 1), preserved here via ``jax.random.uniform``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from edrl.models import nn
import jax
import jax.numpy as jnp

from edrl.config import ModelConfig
from edrl.models.dilr import DILR
from edrl.models.eprl import EPRL
from edrl.models.poe import PoE
from edrl.models.swin2d import SwinTransformer2D
from edrl.models.vit3d import ViT3D
from edrl.ops.distributions import kl_to_standard_normal
from edrl.ops.losses import label_smoothing_cross_entropy


class MedFusion(nn.Module):
    """Returns ``(logits, loss, combined_features, aux)``.

    ``aux`` carries each loss component plus the eval entropy for logging.
    """

    cfg: ModelConfig
    fundus_size: int = 384
    oct_size: Tuple[int, int, int] = (96, 96, 96)

    @nn.compact
    def __call__(
        self,
        fundus: jax.Array,  # [B, H, W, 3]
        oct_vol: jax.Array,  # [B, D, H, W, 1]
        y: Optional[jax.Array] = None,
        *,
        train: bool = True,
        modality_mask: Optional[jax.Array] = None,  # [2] bool: (fundus, oct)
    ):
        cfg = self.cfg
        dtype = jnp.bfloat16 if cfg.use_bfloat16 else jnp.float32
        b = fundus.shape[0]
        c, z_dim = cfg.num_classes, cfg.z_dim

        if modality_mask is not None:
            # Missing-modality inference: zero the absent stream's input and
            # exclude its expert from PoE.
            fundus = fundus * modality_mask[0].astype(fundus.dtype)
            oct_vol = oct_vol * modality_mask[1].astype(oct_vol.dtype)

        # --- backbones (``fusion_net.py:884-885``) ---
        tokens_f, _ = SwinTransformer2D(
            img_size=self.fundus_size,
            embed_dim=cfg.swin_embed_dim,
            depths=cfg.swin_depths,
            num_heads=cfg.swin_heads,
            window=cfg.swin_window,
            dtype=dtype,
            remat=cfg.remat,
            remat_attention=cfg.remat_attention,
            name="transformer_2d",
        )(fundus, deterministic=not train)
        tokens_o, _ = ViT3D(
            volume_size=self.oct_size[0],
            patch_size=cfg.vit3d_patch,
            dim=cfg.oct_embed_dim,
            depth=cfg.vit3d_depth,
            num_heads=cfg.vit3d_heads,
            dtype=dtype,
            remat=cfg.remat,
            name="transformer_3d",
        )(oct_vol, deterministic=not train)

        # --- EPRL per modality (``fusion_net.py:894-899``) ---
        mu_f, sig_f, proxy_f, _, ent_f = EPRL(
            x_dim=cfg.fundus_embed_dim,
            num_tokens=cfg.fundus_tokens,
            z_dim=z_dim,
            num_classes=c,
            sample_num=cfg.sample_num,
            topk=cfg.proxy_topk,
            threshold=cfg.pseudo_label_threshold,
            dtype=dtype,
            name="eprl_fundus",
        )(tokens_f, y, train=train)
        mu_o, sig_o, proxy_o, _, ent_o = EPRL(
            x_dim=cfg.oct_embed_dim,
            num_tokens=cfg.oct_tokens,
            z_dim=z_dim,
            num_classes=c,
            sample_num=cfg.sample_num,
            topk=cfg.proxy_topk,
            threshold=cfg.pseudo_label_threshold,
            dtype=dtype,
            name="eprl_oct",
        )(tokens_o, y, train=train)

        # --- guided features: mu + U[0,1) * sigma (``fusion_net.py:907-910``) ---
        if train:
            u_key = self.make_rng("sample")
        else:
            u_key = jax.random.key(1)  # deterministic eval (ledger #11)
        ku1, ku2 = jax.random.split(u_key)
        # Under a mesh, batch_constraint anchors each flattened [B, C*z]
        # tensor (and, with_sharding_constraint being linear, its backward
        # cotangent) to batch sharding: the cotangents otherwise arrive
        # TP-sharded from the downstream Dense backward dots and GSPMD pays
        # an involuntary replicate+repartition at the un-flatten reshape in
        # the MedFusion backward every step (VERDICT r3 weak #4;
        # parallel.mesh.batch_constraint docstring; no-op single-device).
        from edrl.parallel.mesh import batch_constraint

        guided_f = batch_constraint(
            (mu_f + jax.random.uniform(ku1, mu_f.shape) * sig_f).reshape(
                b, c * z_dim
            )
        )
        guided_o = batch_constraint(
            (mu_o + jax.random.uniform(ku2, mu_o.shape) * sig_o).reshape(
                b, c * z_dim
            )
        )

        # --- PoE + global fusion vector (``fusion_net.py:912-916``) ---
        poe = PoE(
            modality_num=2,
            renormalize_mask=cfg.poe_renormalize_mask,
            name="poe",
        )(
            [mu_f, mu_o], [sig_f, sig_o], modality_mask=modality_mask
        )  # [B, C, z]
        g = nn.relu(batch_constraint(poe.reshape(b, c * z_dim)))
        g = nn.Dense(cfg.fundus_embed_dim, dtype=jnp.float32, name="fc_fundus")(g)
        global_fusion = nn.relu(g)  # [B, 1024]

        # --- DILR (``fusion_net.py:920``) ---
        combined, loss_dilr = DILR(
            fundus_dim=cfg.fundus_embed_dim,
            oct_dim=cfg.oct_embed_dim,
            feature_dim=2 * cfg.fundus_embed_dim,
            guided_in_dim=c * z_dim,
            common_ratio=cfg.common_ratio,
            num_heads=cfg.num_heads,
            off_diag_weight=cfg.bt_off_diag_weight,
            dtype=dtype,
            name="dilr",
        )(tokens_f, tokens_o, global_fusion, guided_f, guided_o, train=train)

        # --- grading head (``fusion_net.py:804-805,929-930``) ---
        h = nn.relu(combined)
        h = nn.Dense(64, dtype=jnp.float32, name="head1")(h)
        h = nn.relu(h)
        logits = nn.Dense(c, dtype=jnp.float32, name="head2")(h)

        aux: Dict[str, jax.Array] = {
            "dilr_loss": loss_dilr,
            "proxy_loss_fundus": proxy_f,
            "proxy_loss_oct": proxy_o,
            "entropy_loss": ent_f + ent_o,
        }

        if y is None:
            return logits, jnp.asarray(0.0), combined, aux

        ce = label_smoothing_cross_entropy(logits, y, cfg.label_smoothing)
        ib = cfg.kl_weight * kl_to_standard_normal(mu_f, sig_f, axis=1) + (
            cfg.kl_weight * kl_to_standard_normal(mu_o, sig_o, axis=1)
        )
        w_proxy = cfg.proxy_weight_train if train else cfg.proxy_weight_eval
        loss = ce + ib + w_proxy * (proxy_f + proxy_o) + cfg.dilr_weight * loss_dilr
        aux.update({"ce_loss": ce, "ib_loss": ib})
        return logits, loss, combined, aux
