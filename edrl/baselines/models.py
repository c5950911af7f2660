"""Baseline zoo: the ~20 comparison models of ``baseline_models.py``.

Uniform interface for every baseline:

    logits, loss, features = model.apply(vars, fundus, oct_vol, y, train=...)

matching the reference contract ``Model(...).forward(X, y) ->
(pred, loss[, features])`` (``baseline_models.py:357-396``).  Loss is plain
cross-entropy as in the reference baselines.  Backbone dims are the rebuild's
own (Res2Net-50 -> 2048, 3-D ResNet-18 -> 512); the reference's hard-coded
pooled dims came from its pretrained checkpoints.

Baselines covered (SURVEY.md section 2.4):
- single modality: ``FundusOnly2D`` (Res2Net2D), ``OctOnly3D`` (ResNet3D),
  ``TwoDTransformer``/``ThreeDTransformer`` (``fusion_net.py:955-1017``)
- late fusion: ``MultiResNet`` (also the deep-ensemble member)
- cross-attention fusion: ``MultiResNetCross``, ``TransCross``
- early fusion: ``MultiEFResNet`` (fundus pooled into extra OCT slices)
- attention fusion: ``MultiCBAMResNet`` with ``CBAM2D``/``CBAM3D``
- MC-dropout fusion: ``MultiDropoutResNet``
- intermediate+late fusion: ``MLC`` / ``MLCTrans``
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

from edrl.models import nn
import jax
import jax.numpy as jnp

from edrl.models.layers import MultiHeadAttention
from edrl.models.resnet2d import Res2Net2D
from edrl.models.resnet3d import ResNet3D
from edrl.models.swin2d import SwinTransformer2D
from edrl.models.vit3d import ViT3D
from edrl.ops.losses import label_smoothing_cross_entropy

Dtype = Any


def _ce(logits, y):
    return label_smoothing_cross_entropy(logits, y, smoothing=0.0)


def _head(x, classes, name, hidden=64):
    h = nn.relu(x)
    h = nn.Dense(hidden, dtype=jnp.float32, name=f"{name}_fc1")(h)
    h = nn.relu(h)
    return nn.Dense(classes, dtype=jnp.float32, name=f"{name}_fc2")(h)


class FundusOnly2D(nn.Module):
    """``Res2Net2D`` (``baseline_models.py:318-354``): fundus-only classifier."""

    classes: int = 2
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, fundus, oct_vol=None, y=None, *, train: bool = True):
        _, pooled = Res2Net2D(dtype=self.dtype, name="backbone")(fundus, train=train)
        logits = _head(pooled, self.classes, "head")
        loss = _ce(logits, y) if y is not None else jnp.asarray(0.0)
        return logits, loss, pooled


class OctOnly3D(nn.Module):
    """``ResNet3D`` (``baseline_models.py:260-316``): OCT-only classifier."""

    classes: int = 2
    blocks: Sequence[int] = (2, 2, 2, 2)
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, fundus=None, oct_vol=None, y=None, *, train: bool = True):
        _, pooled = ResNet3D(blocks=self.blocks, dtype=self.dtype, name="backbone")(
            oct_vol, train=train
        )
        logits = _head(pooled, self.classes, "head")
        loss = _ce(logits, y) if y is not None else jnp.asarray(0.0)
        return logits, loss, pooled


class MultiResNet(nn.Module):
    """Late-fusion concat baseline + deep-ensemble member
    (``baseline_models.py:357-396``, ``fusion_train.py:694-724``)."""

    classes: int = 2
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, fundus, oct_vol, y=None, *, train: bool = True):
        _, pf = Res2Net2D(dtype=self.dtype, name="fundus_backbone")(fundus, train=train)
        _, po = ResNet3D(blocks=(2, 2, 2, 2), dtype=self.dtype, name="oct_backbone")(
            oct_vol, train=train
        )
        feat = jnp.concatenate([pf, po], axis=1)
        logits = _head(feat, self.classes, "head", hidden=256)
        loss = _ce(logits, y) if y is not None else jnp.asarray(0.0)
        return logits, loss, feat


class MultiResNetCross(nn.Module):
    """Cross-attention fusion of the two pooled features
    (``baseline_models.py:399-454``)."""

    classes: int = 2
    embed: int = 256
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, fundus, oct_vol, y=None, *, train: bool = True):
        _, pf = Res2Net2D(dtype=self.dtype, name="fundus_backbone")(fundus, train=train)
        _, po = ResNet3D(blocks=(2, 2, 2, 2), dtype=self.dtype, name="oct_backbone")(
            oct_vol, train=train
        )
        qf = nn.Dense(self.embed, dtype=jnp.float32, name="proj_f")(pf)[:, None, :]
        qo = nn.Dense(self.embed, dtype=jnp.float32, name="proj_o")(po)[:, None, :]
        att_fo = MultiHeadAttention(self.embed, 4, name="cross_fo")(qf, qo, qo)
        att_of = MultiHeadAttention(self.embed, 4, name="cross_of")(qo, qf, qf)
        feat = jnp.concatenate([att_fo[:, 0], att_of[:, 0]], axis=1)
        logits = _head(feat, self.classes, "head", hidden=128)
        loss = _ce(logits, y) if y is not None else jnp.asarray(0.0)
        return logits, loss, feat


class MultiEFResNet(nn.Module):
    """Early fusion: fundus pooled to one grayscale slab and concatenated as
    extra leading OCT slices (``baseline_models.py:817-881``)."""

    classes: int = 2
    extra_slices: int = 3
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, fundus, oct_vol, y=None, *, train: bool = True):
        b, d, h, w, c = oct_vol.shape
        # Fundus RGB -> grayscale slab resized (avg-pool) to the OCT HxW grid.
        gray = jnp.mean(fundus, axis=-1, keepdims=True)  # [B, H_f, W_f, 1]
        fh, fw = gray.shape[1], gray.shape[2]
        # Integer-factor average pooling to (h, w) when divisible (the
        # 384^2 -> 96^2 default), else nearest-index sampling.  The pooled
        # branch actually pools: decimation alone would discard 15/16 of
        # the fundus pixels for a 4x factor.
        if fh % h == 0 and fw % w == 0:
            slab = jnp.mean(
                gray.reshape(b, h, fh // h, w, fw // w, 1), axis=(2, 4)
            )  # [B, h, w, 1]
        else:
            hi = (jnp.arange(h) * fh) // h
            wi = (jnp.arange(w) * fw) // w
            slab = gray[:, hi][:, :, wi]  # [B, h, w, 1]
        slab = jnp.broadcast_to(slab[:, None], (b, self.extra_slices, h, w, 1))
        vol = jnp.concatenate([slab.astype(oct_vol.dtype), oct_vol], axis=1)
        _, pooled = ResNet3D(blocks=(2, 2, 2, 2), dtype=self.dtype, name="backbone")(
            vol, train=train
        )
        logits = _head(pooled, self.classes, "head")
        loss = _ce(logits, y) if y is not None else jnp.asarray(0.0)
        return logits, loss, pooled


class CBAM2D(nn.Module):
    """Channel + spatial attention block (``baseline_models.py:884-940``)."""

    reduction: int = 16

    @nn.compact
    def __call__(self, x):
        c = x.shape[-1]
        avg = jnp.mean(x, axis=(1, 2))
        mx = jnp.max(x, axis=(1, 2))
        fc1 = nn.Dense(max(c // self.reduction, 1), name="ca_fc1")
        fc2 = nn.Dense(c, name="ca_fc2")
        ca = nn.sigmoid(fc2(nn.relu(fc1(avg))) + fc2(nn.relu(fc1(mx))))
        x = x * ca[:, None, None, :]
        sa_in = jnp.concatenate(
            [jnp.mean(x, -1, keepdims=True), jnp.max(x, -1, keepdims=True)], axis=-1
        )
        sa = nn.sigmoid(nn.Conv(1, (7, 7), name="sa_conv")(sa_in))
        return x * sa


class CBAM3D(nn.Module):
    """3-D CBAM (``baseline_models.py:941-976``)."""

    reduction: int = 16

    @nn.compact
    def __call__(self, x):
        c = x.shape[-1]
        avg = jnp.mean(x, axis=(1, 2, 3))
        mx = jnp.max(x, axis=(1, 2, 3))
        fc1 = nn.Dense(max(c // self.reduction, 1), name="ca_fc1")
        fc2 = nn.Dense(c, name="ca_fc2")
        ca = nn.sigmoid(fc2(nn.relu(fc1(avg))) + fc2(nn.relu(fc1(mx))))
        x = x * ca[:, None, None, None, :]
        sa_in = jnp.concatenate(
            [jnp.mean(x, -1, keepdims=True), jnp.max(x, -1, keepdims=True)], axis=-1
        )
        sa = nn.sigmoid(nn.Conv(1, (7, 7, 7), name="sa_conv")(sa_in))
        return x * sa


class MultiCBAMResNet(nn.Module):
    """CBAM-attended fusion baseline (``baseline_models.py:979-1004``)."""

    classes: int = 2
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, fundus, oct_vol, y=None, *, train: bool = True):
        fmap, _ = Res2Net2D(dtype=self.dtype, name="fundus_backbone")(fundus, train=train)
        omap, _ = ResNet3D(blocks=(2, 2, 2, 2), dtype=self.dtype, name="oct_backbone")(
            oct_vol, train=train
        )
        fmap = CBAM2D(name="cbam2d")(fmap.astype(jnp.float32))
        omap = CBAM3D(name="cbam3d")(omap.astype(jnp.float32))
        pf = jnp.mean(fmap, axis=(1, 2))
        po = jnp.mean(omap, axis=(1, 2, 3))
        feat = jnp.concatenate([pf, po], axis=1)
        logits = _head(feat, self.classes, "head", hidden=256)
        loss = _ce(logits, y) if y is not None else jnp.asarray(0.0)
        return logits, loss, feat


class MultiDropoutResNet(nn.Module):
    """MC-dropout fusion (``baseline_models.py:1069-1113``): dropout stays
    active at inference when ``mc=True`` for uncertainty sampling."""

    classes: int = 2
    dropout: float = 0.3
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, fundus, oct_vol, y=None, *, train: bool = True, mc: bool = False):
        _, pf = Res2Net2D(dtype=self.dtype, name="fundus_backbone")(fundus, train=train)
        _, po = ResNet3D(blocks=(2, 2, 2, 2), dtype=self.dtype, name="oct_backbone")(
            oct_vol, train=train
        )
        feat = jnp.concatenate([pf, po], axis=1)
        feat = nn.Dropout(self.dropout)(feat, deterministic=not (train or mc))
        logits = _head(feat, self.classes, "head", hidden=256)
        loss = _ce(logits, y) if y is not None else jnp.asarray(0.0)
        return logits, loss, feat


class TwoDTransformer(nn.Module):
    """Swin-only single-modality baseline (``fusion_net.py:955-986``)."""

    classes: int = 2
    img_size: int = 384
    swin_kwargs: Optional[dict] = None
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, fundus, oct_vol=None, y=None, *, train: bool = True):
        kw = self.swin_kwargs or {}
        _, pooled = SwinTransformer2D(
            img_size=self.img_size, dtype=self.dtype, name="backbone", **kw
        )(fundus, deterministic=not train)
        feat = nn.relu(nn.Dense(768, dtype=jnp.float32, name="fc_fundus")(pooled))
        logits = _head(feat, self.classes, "head")
        loss = _ce(logits, y) if y is not None else jnp.asarray(0.0)
        return logits, loss, feat


class ThreeDTransformer(nn.Module):
    """3-D-ViT-only single-modality baseline (``fusion_net.py:989-1017``)."""

    classes: int = 2
    vit_kwargs: Optional[dict] = None
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, fundus=None, oct_vol=None, y=None, *, train: bool = True):
        kw = self.vit_kwargs or {}
        _, pooled = ViT3D(dtype=self.dtype, name="backbone", **kw)(
            oct_vol, deterministic=not train
        )
        logits = _head(pooled, self.classes, "head")
        loss = _ce(logits, y) if y is not None else jnp.asarray(0.0)
        return logits, loss, pooled


class TransCross(nn.Module):
    """Swin-2D x ViT-3D cross-attention fusion (``baseline_models.py:523-570``)."""

    classes: int = 2
    embed: int = 512
    img_size: int = 384
    swin_kwargs: Optional[dict] = None
    vit_kwargs: Optional[dict] = None
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, fundus, oct_vol, y=None, *, train: bool = True):
        skw = self.swin_kwargs or {}
        vkw = self.vit_kwargs or {}
        _, pf = SwinTransformer2D(
            img_size=self.img_size, dtype=self.dtype, name="fundus_backbone", **skw
        )(fundus, deterministic=not train)
        _, po = ViT3D(dtype=self.dtype, name="oct_backbone", **vkw)(
            oct_vol, deterministic=not train
        )
        qf = nn.Dense(self.embed, dtype=jnp.float32, name="proj_f")(pf)[:, None, :]
        qo = nn.Dense(self.embed, dtype=jnp.float32, name="proj_o")(po)[:, None, :]
        att = MultiHeadAttention(self.embed, 8, name="cross")(qf, qo, qo)
        feat = jnp.concatenate([att[:, 0], qo[:, 0]], axis=1)
        logits = _head(feat, self.classes, "head", hidden=128)
        loss = _ce(logits, y) if y is not None else jnp.asarray(0.0)
        return logits, loss, feat


class MLC(nn.Module):
    """Intermediate + late fusion with a combined classifier, CNN edition
    (``baseline_models.py:728-812``): per-modality heads plus a joint head;
    the loss sums all three CE terms."""

    classes: int = 2
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, fundus, oct_vol, y=None, *, train: bool = True):
        _, pf = Res2Net2D(dtype=self.dtype, name="fundus_backbone")(fundus, train=train)
        _, po = ResNet3D(blocks=(2, 2, 2, 2), dtype=self.dtype, name="oct_backbone")(
            oct_vol, train=train
        )
        logits_f = _head(pf, self.classes, "head_f")
        logits_o = _head(po, self.classes, "head_o")
        feat = jnp.concatenate([pf, po], axis=1)
        logits_c = _head(feat, self.classes, "head_c", hidden=256)
        logits = (logits_f + logits_o + logits_c) / 3.0
        if y is not None:
            loss = _ce(logits_f, y) + _ce(logits_o, y) + _ce(logits_c, y)
        else:
            loss = jnp.asarray(0.0)
        return logits, loss, feat


class MLCTrans(nn.Module):
    """MLC, transformer edition (``baseline_models.py:656-727``)."""

    classes: int = 2
    img_size: int = 384
    swin_kwargs: Optional[dict] = None
    vit_kwargs: Optional[dict] = None
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, fundus, oct_vol, y=None, *, train: bool = True):
        skw = self.swin_kwargs or {}
        vkw = self.vit_kwargs or {}
        _, pf = SwinTransformer2D(
            img_size=self.img_size, dtype=self.dtype, name="fundus_backbone", **skw
        )(fundus, deterministic=not train)
        _, po = ViT3D(dtype=self.dtype, name="oct_backbone", **vkw)(
            oct_vol, deterministic=not train
        )
        logits_f = _head(pf, self.classes, "head_f")
        logits_o = _head(po, self.classes, "head_o")
        feat = jnp.concatenate([pf, po], axis=1)
        logits_c = _head(feat, self.classes, "head_c", hidden=256)
        logits = (logits_f + logits_o + logits_c) / 3.0
        if y is not None:
            loss = _ce(logits_f, y) + _ce(logits_o, y) + _ce(logits_c, y)
        else:
            loss = jnp.asarray(0.0)
        return logits, loss, feat


class FeatureExtractor2D(nn.Module):
    """Standalone Res2Net feature-extractor wrappers
    (``Medical_feature_2DNet`` / ``Medical_base_2DNet`` family,
    ``baseline_models.py:8-120``).  ``output='map'`` returns the spatial
    feature map, ``'pooled'`` the global vector, ``'logits'`` adds a head."""

    classes: int = 2
    output: str = "pooled"  # "map" | "pooled" | "logits"
    base_width: int = 26
    scales: int = 4
    dropout: float = 0.0  # >0 reproduces the MC-dropout variant
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, fundus, oct_vol=None, y=None, *, train: bool = True, mc: bool = False):
        fmap, pooled = Res2Net2D(
            base_width=self.base_width, scales=self.scales, dtype=self.dtype,
            name="backbone",
        )(fundus, train=train)
        if self.dropout > 0:
            pooled = nn.Dropout(self.dropout)(pooled, deterministic=not (train or mc))
        if self.output == "map":
            return fmap
        if self.output == "pooled":
            return pooled
        logits = _head(pooled, self.classes, "head")
        loss = _ce(logits, y) if y is not None else jnp.asarray(0.0)
        return logits, loss, pooled


class FeatureExtractor3D(nn.Module):
    """Standalone 3-D ResNet feature-extractor wrappers
    (``Medical_base_3DNet`` / ``Medical_feature_3DNet`` family,
    ``baseline_models.py:123-258``); ``blocks=(1,1,1,1)`` is the Med3D
    ResNet-10 variant, ``(2,2,2,2)`` ResNet-18."""

    classes: int = 2
    output: str = "pooled"
    blocks: Sequence[int] = (1, 1, 1, 1)
    dropout: float = 0.0
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, fundus=None, oct_vol=None, y=None, *, train: bool = True, mc: bool = False):
        fmap, pooled = ResNet3D(blocks=self.blocks, dtype=self.dtype, name="backbone")(
            oct_vol, train=train
        )
        if self.dropout > 0:
            pooled = nn.Dropout(self.dropout)(pooled, deterministic=not (train or mc))
        if self.output == "map":
            return fmap
        if self.output == "pooled":
            return pooled
        logits = _head(pooled, self.classes, "head")
        loss = _ce(logits, y) if y is not None else jnp.asarray(0.0)
        return logits, loss, pooled


class MultiEnsembleResNet(nn.Module):
    """Structural ensemble-member variant (``Multi_ensemble_ResNet``,
    ``baseline_models.py:1007-1038``): the 2-D stream is the 14w8s Res2Net
    (``Medical_base2_2DNet`` -> ``res2net50_v1b_14w_8s``) instead of the
    26w4s default, the 3-D stream is ResNet-10, and the classifier is the
    reference's single Linear on the concat (no hidden layer)."""

    classes: int = 2
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, fundus, oct_vol, y=None, *, train: bool = True):
        _, pf = Res2Net2D(
            base_width=14, scales=8, dtype=self.dtype, name="fundus_backbone"
        )(fundus, train=train)
        _, po = ResNet3D(blocks=(1, 1, 1, 1), dtype=self.dtype, name="oct_backbone")(
            oct_vol, train=train
        )
        feat = jnp.concatenate([pf, po], axis=1)
        logits = nn.Dense(self.classes, dtype=jnp.float32, name="fc")(feat)
        loss = _ce(logits, y) if y is not None else jnp.asarray(0.0)
        return logits, loss, feat


class MultiEnsemble3DResNet(nn.Module):
    """Ensemble-member variant with a deeper 3-D backbone
    (``Multi_ensemble_3D_ResNet``, ``baseline_models.py:1041-1068``):
    ResNet-18 blocks (``Medical_base2_3DNet`` -> ``model_depth=18``) under
    the 26w4s 2-D stream — the members differ structurally, not just by
    learning rate."""

    classes: int = 2
    blocks_3d: Sequence[int] = (2, 2, 2, 2)
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, fundus, oct_vol, y=None, *, train: bool = True):
        _, pf = Res2Net2D(dtype=self.dtype, name="fundus_backbone")(fundus, train=train)
        _, po = ResNet3D(blocks=self.blocks_3d, dtype=self.dtype, name="oct_backbone")(
            oct_vol, train=train
        )
        feat = jnp.concatenate([pf, po], axis=1)
        logits = nn.Dense(self.classes, dtype=jnp.float32, name="fc")(feat)
        loss = _ce(logits, y) if y is not None else jnp.asarray(0.0)
        return logits, loss, feat
