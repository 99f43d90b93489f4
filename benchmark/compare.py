"""The comparison that decides `correct`.

Each output row the program served is held against the reference's row
for the same input. A row is compared as centred logits: the logits
themselves where the model's output is logits, the logarithm of the
probabilities where it is a softmax (a softmax's logarithm is the
logits up to a constant per row, which the centring removes). The
number is the row's relative L2 error,

    |z_program - z_reference| / |z_reference|,   z centred per row,

and a run reports the largest over every row it checked. Both sides are
taken to float32 first; probabilities are clamped at float32's smallest
normal before the logarithm, so a probability that rounded to 0 on one
side reads as -87.3 and not as -inf.
"""

from __future__ import annotations

import torch

_TINY = torch.finfo(torch.float32).tiny


def centred(rows: torch.Tensor, output: str) -> torch.Tensor:
    z = rows.float()
    if output == "probabilities":
        z = torch.log(z.clamp(min=_TINY))
    elif output != "logits":
        raise ValueError(f"unknown output kind {output!r}")
    return z - z.mean(dim=-1, keepdim=True)


def row_errors(program: torch.Tensor, reference: torch.Tensor,
               output: str) -> torch.Tensor:
    """Relative L2 error of each row of `program` against `reference`."""
    if program.shape != reference.shape:
        raise ValueError(
            f"program rows {tuple(program.shape)} against reference rows "
            f"{tuple(reference.shape)}")
    zp = centred(program.to(reference.device), output)
    zr = centred(reference, output)
    return (zp - zr).norm(dim=-1) / zr.norm(dim=-1)
