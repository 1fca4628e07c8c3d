"""Datasets and batching.

The port's own copy of the numpy module ``sea_tpu/data/datasets.py``;
``device_resident_budget`` asks torch for the card's free memory where
the JAX one asks its device.

Mirrors the reference's data objects re-expressed as plain-array pipelines:
- EncoderDecoderDataset (utils/data_processors.py:376-386): trivial snapshot
  dataset (input == target, autoencoding) -> here just an array + iterator.
- TemporalDataset (:388-452): chop each trajectory's latent sequence into
  windows of ``src_len`` with stride ``src_len - overlap``; each item is
  (src, tgt=next-step targets, tgt_original un-encoded fields, ib window).
- The SEA layout switch (train/train_encoder.py:121-132): 'isolate' permutes
  [B,P,C,F] -> [B,P,F,C]; 'mixed' reshapes without permuting (deliberate
  field/cell mixing experiment) — both preserved.

Batching: seeded-shuffle minibatch index iterators (the reference uses
torch DataLoader with a seeded generator, train/train_temporal.py:81-86),
in the JAX package's order; the last partial batch is dropped when
drop_remainder=True (training), and evaluation batches are padded to one
size.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


def apply_sea_layout(patched: np.ndarray, layout: str) -> np.ndarray:
    """patched: [B, P, C, F] -> [B, P, F, C]."""
    if layout == "isolate":
        return np.ascontiguousarray(patched.transpose(0, 1, 3, 2))
    if layout == "mixed":
        B, P, C, F = patched.shape
        return patched.reshape(B, P, F, C)
    raise ValueError(f"Invalid SEA layout: {layout!r}")


def invert_sea_layout(x: np.ndarray, layout: str) -> np.ndarray:
    """[B, P, F, C] -> [B, P, C, F], the inverse of apply_sea_layout."""
    if layout == "isolate":
        return np.ascontiguousarray(x.transpose(0, 1, 3, 2))
    if layout == "mixed":
        B, P, F, C = x.shape
        return x.reshape(B, P, C, F)
    raise ValueError(f"Invalid SEA layout: {layout!r}")


def split_indices(total: int, train_fraction: float, val_fraction: float,
                  seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shuffled train/val/test split (train_encoder.py:89-105 — np.round
    lengths, same RNG construction: np.random.seed + shuffle)."""
    rng = np.random.RandomState(seed)
    indices = np.arange(total)
    rng.shuffle(indices)
    train_len = int(np.round(total * train_fraction))
    val_len = int(np.round(total * val_fraction))
    return (indices[:train_len],
            indices[train_len:train_len + val_len],
            indices[train_len + val_len:])


@dataclasses.dataclass
class TemporalWindows:
    """All windows of all trajectories, stacked (static shapes).

    src:          [W, L, G, E]  model input
    tgt:          [W, L, G, E]  next-step targets
    tgt_original: [W, L, N, F]  un-encoded fields aligned with tgt
    ib:           [W, L, ib_num]
    """

    src: np.ndarray
    tgt: np.ndarray
    tgt_original: np.ndarray
    ib: np.ndarray

    def __len__(self) -> int:
        return self.src.shape[0]


def make_temporal_windows(latents: np.ndarray, originals: np.ndarray,
                          ib: np.ndarray, src_len: int, overlap: int = 0, *,
                          time_shift_rng: Optional[np.random.RandomState]
                          = None) -> TemporalWindows:
    """latents: [tr, T, G, E]; originals: [tr, T, N, F]; ib: [tr, T, ib_num].

    Window extraction mirrors TemporalDataset.__getitem__
    (data_processors.py:412-452): per trajectory, num_windows = T // step
    windows at starts w*step, with src = lat[s:s+L], tgt = lat[s+1:s+L+1],
    tgt_original = orig[s+1:s+L+1], ib_out = ib[s:s+L].

    ``time_shift_rng``: the reference's random time shifting
    (``dataset_time_shifting``, data_processors.py:436-439): each window's
    start moves by a shift drawn from [0, T - step), clamped so the window
    stays inside the trajectory, as the JAX package draws it. The training
    loop calls this once per epoch with a seeded RandomState.
    """
    if overlap >= src_len:
        raise ValueError(
            f"dataset_overlap ({overlap}) must be < dataset_src_len "
            f"({src_len}); the window stride src_len - overlap must be "
            "positive (data_processors.py:397)")
    step = src_len - overlap
    tr, T = latents.shape[:2]
    srcs, tgts, origs, ibs = [], [], [], []
    for t in range(tr):
        num = T // step
        for w in range(num):
            s = w * step
            if time_shift_rng is not None and T - step > 0:
                shift = int(time_shift_rng.randint(0, T - step))
                s = max(0, min(s + shift, T - src_len - 1))
            if s + src_len + 1 > T:
                # The reference would produce a ragged (short) tgt here and
                # crash in the DataLoader collate; we skip such windows.
                continue
            srcs.append(latents[t, s:s + src_len])
            tgts.append(latents[t, s + 1:s + src_len + 1])
            origs.append(originals[t, s + 1:s + src_len + 1])
            ibs.append(ib[t, s:s + src_len])
    if not srcs:
        raise ValueError(
            f"no temporal windows: {tr} trajectories of length {T} with "
            f"src_len={src_len} (need T >= src_len+1 and a non-empty split)")
    return TemporalWindows(src=np.stack(srcs), tgt=np.stack(tgts),
                           tgt_original=np.stack(origs), ib=np.stack(ibs))


def batch_index_iterator(n: int, batch_size: int, *, shuffle: bool,
                         seed: int = 0, epoch: int = 0,
                         drop_remainder: bool = False
                         ) -> Iterator[np.ndarray]:
    """Yield index arrays for minibatches, in the JAX package's shuffle
    order; the training loop gathers its batches on the device with
    them."""
    idx = np.arange(n)
    if shuffle:
        rng = np.random.RandomState((seed * 1_000_003 + epoch) % (2 ** 31))
        rng.shuffle(idx)
    end = (n - n % batch_size) if drop_remainder else n
    for start in range(0, end, batch_size):
        yield idx[start:start + batch_size]


def padded_batch_index_iterator(n: int, batch_size: int
                                ) -> Iterator[Tuple[np.ndarray, int]]:
    """Yield (indices, n_valid) with every index array of length
    batch_size — the tail padded by repeating its last valid index. The
    evaluation loop gathers its batches on the device with them and masks
    the padded rows out with n_valid."""
    for start in range(0, n, batch_size):
        end = min(start + batch_size, n)
        idx = np.arange(start, end)
        k = end - start
        if k < batch_size:
            idx = np.concatenate(
                [idx, np.full(batch_size - k, end - 1, dtype=idx.dtype)])
        yield idx, k


def device_resident_budget(configured_max: int, device) -> int:
    """Bytes a training loop may pin on ``device`` for its train and validation
    splits (TrainConfig.device_resident_max_bytes): the configured cap,
    and on a CUDA device at most half of its free memory, so a split that
    fits a per-step copy never takes the step's working memory."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return configured_max
    free, _ = torch.cuda.mem_get_info(device)
    return min(configured_max, free // 2)


def ib_is_time_constant(*window_sets) -> bool:
    """True when every window's conditioning stream is constant over time
    (e.g. a per-trajectory Reynolds number — both shipped datasets).
    Checked on the HOST arrays once per run, never guessed: the temporal
    train driver and the CLI serving path use it to enable
    TemporalModelConfig.ib_time_constant (ib-only activations computed on
    [B, 1] rows and broadcast — identical numerics, ~T x fewer rows)."""
    found = False
    for w in window_sets:
        ib = getattr(w, "ib", w)
        if ib is None or len(ib) == 0:
            continue
        found = True
        arr = np.asarray(ib)
        if not bool(np.all(arr == arr[:, :1])):
            return False
    return found
