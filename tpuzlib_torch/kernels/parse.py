"""Greedy-parse token starts (the LZ77 parse walk) for the device encoder.

Counterpart of tpuzlib/kernels/parse_pallas.py:segment_parse_pallas.  The
encoder forces a token break every SEG bytes, so each segment's chain
i -> i + step[i] is independent of every other.  On a CUDA tensor the
wrapper launches csrc/parse.cu (one warp per segment: span exits, the
chain from span to span, then each span's marks); on a CPU tensor it runs
the plain version, deflate_device.segment_parse_xla.
"""

from __future__ import annotations

import torch

from . import _build
from .deflate_device import SEG, segment_parse_xla

MAX_SEG = 8192  # a warp holds its segment in shared memory, about 4 bytes a position


def segment_parse(step: torch.Tensor, n_valid: int, seg: int = SEG) -> torch.Tensor:
    """Token-start mask (bool[n]) from an int32 step tape whose steps are
    >= 1 and never cross a `seg` boundary; positions >= n_valid are 0."""
    if _build.on_cpu(step):
        return segment_parse_xla(step, n_valid, seg)
    n = step.shape[0]
    _build.check_inputs("segment_parse", (n,), step)
    if not 1 <= seg <= MAX_SEG:
        raise ValueError("segment_parse: seg must be in 1..%d, got %d" % (MAX_SEG, seg))
    member = torch.empty(n, dtype=torch.bool, device=step.device)
    if n == 0:
        return member
    _build.launch(
        "segment_parse", "tz_segment_parse", step.device,
        step.data_ptr(), member.data_ptr(), n, int(n_valid), seg,
    )
    return member
