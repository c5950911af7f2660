"""3-D ResNet OCT backbone for the baseline zoo.

Reconstructs the missing ``Models.generate_model`` Med3D/MedicalNet-style 3-D
ResNets (SURVEY.md section 2.8 item 3; consumed by
``baseline_models.py:123-258``): basic-block 3-D ResNet-10/18 over the OCT
volume.  The reference loaded hard-coded pretrained ``.pth`` weights
(``baseline_models.py:132``); here training is from scratch (checkpoint
import is a train-layer concern).

NDHWC layout; bf16 compute / f32 params.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

from edrl.models import nn
import jax
import jax.numpy as jnp

Dtype = Any


class BasicBlock3D(nn.Module):
    channels: int
    stride: int = 1
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x, *, train: bool = True):
        # momentum 0.9 == torch BatchNorm default 0.1 (default 0.99).
        norm = lambda name: nn.BatchNorm(
            use_running_average=not train, momentum=0.9, dtype=jnp.float32,
            name=name,
        )
        s = (self.stride,) * 3
        h = nn.Conv(self.channels, (3, 3, 3), strides=s, use_bias=False, dtype=self.dtype)(x)
        h = nn.relu(norm("bn1")(h))
        h = nn.Conv(self.channels, (3, 3, 3), use_bias=False, dtype=self.dtype)(h)
        h = norm("bn2")(h)
        if x.shape[-1] != self.channels or self.stride != 1:
            x = nn.Conv(
                self.channels, (1, 1, 1), strides=s, use_bias=False, dtype=self.dtype,
                name="downsample",
            )(x)
            x = norm("bn_down")(x)
        return nn.relu(x + h)


class ResNet3D(nn.Module):
    """Returns ``(feature_map, pooled)``; blocks (1,1,1,1) = ResNet-10,
    (2,2,2,2) = ResNet-18 (the two Med3D variants the reference uses)."""

    blocks: Sequence[int] = (1, 1, 1, 1)
    base_channels: int = 64
    dtype: Dtype = jnp.float32

    @nn.compact
    def __call__(self, x, *, train: bool = True) -> Tuple[jax.Array, jax.Array]:
        x = x.astype(self.dtype)
        h = nn.Conv(
            self.base_channels,
            (7, 7, 7),
            strides=(2, 2, 2),
            use_bias=False,
            dtype=self.dtype,
            name="stem",
        )(x)
        h = nn.BatchNorm(
            use_running_average=not train, momentum=0.9, dtype=jnp.float32,
            name="bn_stem",
        )(h)
        h = nn.relu(h)
        h = nn.max_pool(h, (3, 3, 3), strides=(2, 2, 2), padding="SAME")

        ch = self.base_channels
        for stage, depth in enumerate(self.blocks):
            for i in range(depth):
                h = BasicBlock3D(
                    channels=ch,
                    stride=2 if (i == 0 and stage > 0) else 1,
                    dtype=self.dtype,
                    name=f"stage{stage}_block{i}",
                )(h, train=train)
            if stage < len(self.blocks) - 1:
                ch *= 2

        pooled = jnp.mean(h, axis=(1, 2, 3)).astype(jnp.float32)
        return h, pooled
