"""Res2Net-style 2-D CNN backbone for the baseline zoo.

Reconstructs the missing ``Models.res2net`` backbones (SURVEY.md section 2.8
item 4; consumed by ``baseline_models.py:8-120``): a bottleneck ResNet whose
3x3 stage is the Res2Net multi-scale hierarchy — the width is split into
``scales`` groups, each group's 3x3 conv receives the previous group's output
added in, giving multi-receptive-field features at one layer's cost.

NHWC layout throughout; bf16 compute / f32 params.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

from edrl.models import nn
import jax
import jax.numpy as jnp

Dtype = Any


class Res2NetBottleneck(nn.Module):
    width: int  # per-scale width * scales == mid channels
    out_channels: int
    scales: int = 4
    stride: int = 1
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x, *, train: bool = True):
        mid = self.width * self.scales
        # momentum 0.9 == torch BatchNorm default 0.1 (the default 0.99 would
        # track running stats 10x slower than the reference).
        norm = lambda name: nn.BatchNorm(
            use_running_average=not train, momentum=0.9, dtype=jnp.float32,
            name=name,
        )
        h = nn.Conv(mid, (1, 1), use_bias=False, dtype=self.dtype, name="conv1")(x)
        h = nn.relu(norm("bn1")(h))

        # Multi-scale 3x3 hierarchy over `scales` splits.
        splits = jnp.split(h, self.scales, axis=-1)
        outs = []
        prev = None
        for i, sp in enumerate(splits):
            if i == 0:
                # Split 0 never goes through a conv (scales-1 convs per
                # block, as in Res2Net): identity in ordinary blocks,
                # avg-pooled in downsampling ("stage") blocks.  Guarding on
                # i alone (not i and stride) avoids building a conv3x3_0
                # whose output was previously overwritten by the pool —
                # dead parameters and a wasted full conv per stage block.
                outs.append(
                    sp
                    if self.stride == 1
                    else nn.avg_pool(
                        sp, (3, 3),
                        strides=(self.stride, self.stride),
                        padding="SAME",
                    )
                )
                continue
            inp = sp if prev is None else sp + prev
            o = nn.Conv(
                self.width,
                (3, 3),
                strides=(self.stride, self.stride),
                use_bias=False,
                dtype=self.dtype,
                name=f"conv3x3_{i}",
            )(inp)
            o = nn.relu(norm(f"bn3x3_{i}")(o))
            outs.append(o)
            # Stage blocks (stride > 1) have no hierarchical residual chain.
            prev = o if self.stride == 1 else None
        h = jnp.concatenate(outs, axis=-1)

        h = nn.Conv(
            self.out_channels, (1, 1), use_bias=False, dtype=self.dtype, name="conv3"
        )(h)
        h = norm("bn3")(h)

        if x.shape[-1] != self.out_channels or self.stride != 1:
            x = nn.Conv(
                self.out_channels,
                (1, 1),
                strides=(self.stride, self.stride),
                use_bias=False,
                dtype=self.dtype,
                name="downsample",
            )(x)
            x = norm("bn_down")(x)
        return nn.relu(x + h)


class Res2Net2D(nn.Module):
    """Returns ``(feature_map [B, H/32, W/32, C], pooled [B, C])``.

    Default config mirrors res2net50_v1b_26w_4s: base width 26, scales 4,
    stage blocks (3, 4, 6, 3), final channels 2048.
    """

    base_width: int = 26
    scales: int = 4
    blocks: Sequence[int] = (3, 4, 6, 3)
    stem_channels: int = 64
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x, *, train: bool = True) -> Tuple[jax.Array, jax.Array]:
        x = x.astype(self.dtype)
        # momentum 0.9 == torch BatchNorm default 0.1 (the default 0.99 would
        # track running stats 10x slower than the reference).
        norm = lambda name: nn.BatchNorm(
            use_running_average=not train, momentum=0.9, dtype=jnp.float32,
            name=name,
        )
        # v1b deep stem: three 3x3 convs.
        h = nn.Conv(32, (3, 3), strides=(2, 2), use_bias=False, dtype=self.dtype)(x)
        h = nn.relu(norm("bn_stem1")(h))
        h = nn.Conv(32, (3, 3), use_bias=False, dtype=self.dtype)(h)
        h = nn.relu(norm("bn_stem2")(h))
        h = nn.Conv(self.stem_channels, (3, 3), use_bias=False, dtype=self.dtype)(h)
        h = nn.relu(norm("bn_stem3")(h))
        h = nn.max_pool(h, (3, 3), strides=(2, 2), padding="SAME")

        channels = 256
        for stage, depth in enumerate(self.blocks):
            width = self.base_width * (2**stage)
            for i in range(depth):
                h = Res2NetBottleneck(
                    width=width,
                    out_channels=channels,
                    scales=self.scales,
                    stride=2 if (i == 0 and stage > 0) else 1,
                    dtype=self.dtype,
                    name=f"stage{stage}_block{i}",
                )(h, train=train)
            channels *= 2

        pooled = jnp.mean(h, axis=(1, 2)).astype(jnp.float32)
        return h, pooled
