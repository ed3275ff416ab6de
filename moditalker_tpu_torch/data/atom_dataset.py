"""AToM training data (port of ``moditalker_tpu/data/atom_dataset.py``,
ref AToM/dataset/atom_dataset.py), numpy only.

Items are loaded into RAM once, size-bucketed into batches, and collated
onto the fixed ``LENGTH_BUCKETS`` ladder with the batch dimension padded to
``batch_size``, as in the JAX package: every batch of an epoch lands on one
of at most len(ladder) shapes, and the batches are the JAX package's on the
same seed.

Each raw record holds: mel [T,80], hubert [T,1024], coeff [T/2,257]
(exp = 80:144, translation = 254:257, euler angles = 224:227 → quaternion),
idexp_lm3d [T/2,68,3]. The collated batch matches the reference layout
(AToM/AToM.py:130-142).
"""

from __future__ import annotations

import os
import random as pyrandom

import numpy as np

from .indexed import IndexedReader

try:  # optional: only needed for pose quaternions
    from scipy.spatial.transform import Rotation as _R

    def euler2quat(euler: np.ndarray) -> np.ndarray:
        return _R.from_euler("xyz", euler).as_quat()
except ImportError:  # pragma: no cover
    def euler2quat(euler: np.ndarray) -> np.ndarray:
        raise RuntimeError("scipy required for pose quaternions")


def batch_by_size(indices, sizes, batch_size=64, max_tokens=60000,
                  required_batch_size_multiple=1):
    """Size-bucketed batching (ref atom_dataset.py:57-117, fairseq-style)."""
    def is_full(batch, num_tokens):
        if len(batch) == 0:
            return False
        if len(batch) == batch_size:
            return True
        return num_tokens > max_tokens

    bsz_mult = required_batch_size_multiple
    sample_len = 0
    sample_lens: list[int] = []
    batch: list[int] = []
    batches: list[list[int]] = []
    for idx in indices:
        num_tokens = sizes[idx]
        sample_lens.append(num_tokens)
        sample_len = max(sample_len, num_tokens)
        assert sample_len <= max_tokens
        num_tokens = (len(batch) + 1) * sample_len
        if is_full(batch, num_tokens):
            mod_len = max(
                bsz_mult * (len(batch) // bsz_mult), len(batch) % bsz_mult
            )
            batches.append(batch[:mod_len])
            batch = batch[mod_len:]
            sample_lens = sample_lens[mod_len:]
            sample_len = max(sample_lens) if sample_lens else 0
        batch.append(idx)
    if batch:
        batches.append(batch)
    return batches


# Fixed padded-length ladder (mel-frame units), the JAX package's: the
# reference's max-in-batch padding (atom_dataset.py:198, pad-to-multiple-of-8)
# gives dozens of shapes over LRS3's length spread; the ladder bounds them to
# len(LENGTH_BUCKETS).
LENGTH_BUCKETS = (64, 128, 192, 256, 320, 384, 448, 512, 640, 768, 1024)


def bucket_length(n: int) -> int:
    """Smallest ladder entry ≥ n (beyond the ladder: next multiple of 128)."""
    for b in LENGTH_BUCKETS:
        if n <= b:
            return b
    return ((n + 127) // 128) * 128


def _pad_2d(arrays, max_len, pad_value=0.0):
    b = len(arrays)
    c = arrays[0].shape[1]
    out = np.full((b, max_len, c), pad_value, dtype=np.float32)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a[:max_len]
    return out


class AtomSequenceDataset:
    """In-memory LRS3 sequence dataset with static-shape collation."""

    X_MULTIPLY = 8

    def __init__(self, ds_path: str, split: str = "train"):
        self.ds_path = ds_path
        self.split = split
        self.items: list[dict] = []
        self.sizes: list[int] = []
        self._load()

    def _load(self):
        reader = IndexedReader(os.path.join(self.ds_path, self.split))
        for raw in reader:
            if raw is None:
                self.items.append(None)
                self.sizes.append(0)
                continue
            coeff = np.asarray(raw["coeff"], np.float32)
            t_lm = raw["idexp_lm3d"].shape[0]
            pose = np.concatenate(
                [coeff[:, 254:257], euler2quat(coeff[:, 224:227])], axis=1
            ).astype(np.float32)
            item = {
                "item_id": raw["item_id"],
                "mel": np.asarray(raw["mel"], np.float32),
                "hubert": np.asarray(raw["hubert"], np.float32),
                "exp": coeff[:, 80:144],
                "pose": pose,
                "idexp_lm3d": np.asarray(
                    raw["idexp_lm3d"], np.float32).reshape(t_lm, -1),
            }
            self.items.append(item)
            self.sizes.append(item["mel"].shape[0])

    def __len__(self):
        return len(self.items)

    def collate(self, idxs, static_shapes: bool = True,
                pad_batch_to: int | None = None) -> dict | None:
        """``static_shapes`` snaps the padded length onto LENGTH_BUCKETS;
        ``pad_batch_to`` pads the batch dimension by cycling samples (the
        token-budget bucketing yields ragged batch sizes). Together they
        bound the number of batch shapes."""
        samples = [self.items[i] for i in idxs if self.items[i] is not None]
        if not samples:
            return None
        if pad_batch_to is not None and len(samples) < pad_batch_to:
            base = list(samples)
            while len(samples) < pad_batch_to:
                samples.append(base[len(samples) % len(base)])
        x_len = max(s["mel"].shape[0] for s in samples)
        x_len = x_len + (self.X_MULTIPLY - x_len % self.X_MULTIPLY) % self.X_MULTIPLY
        if static_shapes:
            x_len = bucket_length(x_len)
        y_len = x_len // 2
        mel = _pad_2d([s["mel"] for s in samples], x_len)
        hubert = _pad_2d([s["hubert"] for s in samples], x_len)
        pose = _pad_2d([s["pose"] for s in samples], y_len)
        batch = {
            "item_id": [s["item_id"] for s in samples],
            "mel": mel,
            "hubert": hubert,
            "exp": _pad_2d([s["exp"] for s in samples], y_len),
            "pose": pose,
            "idexp_lm3d": _pad_2d([s["idexp_lm3d"] for s in samples], y_len),
            "x_mask": (np.abs(mel).sum(-1) > 0).astype(np.float32),
            "y_mask": (np.abs(pose).sum(-1) > 0).astype(np.float32),
        }
        return batch

    def epoch_batches(self, batch_size: int, seed: int = 0, repeats: int = 50):
        """Bucketed batch index lists, repeated+shuffled like the reference
        (atom_dataset.py:234-238)."""
        order = np.argsort(np.asarray(self.sizes), kind="mergesort")
        batches = batch_by_size(order.tolist(), self.sizes, batch_size)
        batches = batches * repeats
        rng = pyrandom.Random(seed)
        rng.shuffle(batches)
        return batches

    def iter_epoch(self, batch_size: int, seed: int = 0,
                   static_shapes: bool = True):
        """Collated batches; with ``static_shapes`` every batch lands on a
        (batch_size, LENGTH_BUCKETS entry) shape."""
        for idxs in self.epoch_batches(batch_size, seed):
            b = self.collate(idxs, static_shapes=static_shapes,
                             pad_batch_to=batch_size if static_shapes
                             else None)
            if b is not None:
                yield b


def synthetic_batch(batch_size: int = 8, horizon: int = 156,
                    seed: int = 0) -> dict:
    """Random batch with the exact training layout — used by tests and
    benchmarks when no LRS3 database is present."""
    rng = np.random.default_rng(seed)
    return {
        "hubert": rng.normal(size=(batch_size, horizon * 2, 1024)).astype(
            np.float32),
        "idexp_lm3d": np.tanh(
            rng.normal(size=(batch_size, horizon, 204))).astype(np.float32),
        "pose": rng.normal(size=(batch_size, horizon, 7)).astype(np.float32),
    }


def training_arrays(batch: dict, horizon: int) -> tuple:
    """(residual, face, cond) from a collated batch — the reference's
    residual construction (AToM/AToM.py:153-164): target = idexp_lm3d minus
    the first-frame keypoint broadcast over the horizon."""
    x = batch["idexp_lm3d"][:, :horizon]
    cond_keypoint = np.repeat(x[:, 0:1, :], horizon, axis=1)
    residual = x - cond_keypoint
    return residual, cond_keypoint, batch["hubert"][:, : horizon * 2]
