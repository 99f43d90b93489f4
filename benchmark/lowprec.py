"""The control's precision: float8 e4m3 with a per-tensor scale.

The configurations state bfloat16; the nearest precision below it that
a later change might be tempted to run is fp8. `fp8` rounds a tensor to
the values an e4m3 product would read: scaled so that its largest
magnitude lands on e4m3's largest (448), cast, and scaled back, all in
float32. The references apply it to every operand of a convolution or a
matrix product when given `quantize=fp8`.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    t = t.float()
    amax = t.abs().amax().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).float() / scale
