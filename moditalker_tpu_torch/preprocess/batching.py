"""Fixed-size chunked dispatch for the preprocessing nets (port of
``moditalker_tpu/preprocess/batching.py``).

S3FD, FAN and ReconNet run over all frames of a video, a batch whose size is
the clip length. ``padded_chunk_apply`` runs them in chunks of a fixed size
and pads the last chunk by repeating its final frame, as the JAX package does
(there so that XLA compiles one program). Here it keeps one shape per net, so
cuDNN plans once per net and not once per clip length; every net runs in
eval mode, so a frame's result does not depend on the rows beside it.
"""

from __future__ import annotations

import numpy as np
import torch


def padded_chunk_apply(fn, x: np.ndarray, chunk: int = 64):
    """Apply ``fn`` (batched over the leading axis; a tensor, or a list of
    tensors, out) to ``x`` in pieces of ``chunk`` rows, the last padded by
    repeating its final row; the padded rows are trimmed and the pieces
    concatenated along axis 0, as numpy arrays.

    The device queues every chunk before the first result is copied back:
    the results stay on the device until the end."""
    outs = []
    for lo in range(0, max(x.shape[0], 1), chunk):
        part = np.asarray(x[lo : lo + chunk])
        n = part.shape[0]
        if n < chunk:
            pad = np.repeat(part[-1:], chunk - n, axis=0)
            part = np.concatenate([part, pad], axis=0)
        out = fn(part)
        outs.append([o[:n] for o in out] if isinstance(out, list)
                    else out[:n])
    if isinstance(outs[0], list):
        return [torch.cat(parts).cpu().numpy() for parts in zip(*outs)]
    return torch.cat(outs).cpu().numpy()
