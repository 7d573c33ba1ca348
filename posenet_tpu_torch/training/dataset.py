"""Training dataset: images + prepared ground truth -> numpy batches.

A copy of `posenet_tpu.training.dataset` on the port's preprocessing:
list images in a directory, load the padded GT that
`ground_truth.prepare_ground_truth_data` wrote, and yield stacked batches.

- Batches are NHWC float32 in [-1, 1] with keypoints in (y, x) grid
  order, as numpy arrays: the trainer uploads them.
- Images are resized to one square stride-valid resolution at load.
- `iter_batches` overlaps host image decode with the device step: a thread
  pool assembles each batch (cv2 releases the GIL) and a bounded prefetch
  queue holds whole batches. `cache_images=True` keeps the decoded and
  resized uint8 frames in RAM after the first epoch.
- The shuffle and the flip coins come from numpy RNGs seeded by the
  caller's seed, so that a (seed, epoch) replays bit for bit, and equals the
  JAX package's batches on the same directory.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from posenet_tpu_torch.constants import LEFT_RIGHT_SWAP
from posenet_tpu_torch.preprocess import valid_resolution
from posenet_tpu_torch.training.ground_truth import (HEATMAP_SHAPE,
                                                     load_ground_truth_data, to_yx)

IMAGE_EXTENSIONS = ('.png', '.jpg', '.jpeg')


class PosenetDataset:
    """Images + prepared keypoint GT.

    Args:
      image_dir: directory of training images.
      keypoints_dir: `keypoints_updated`-style directory produced by
        `ground_truth.prepare_ground_truth_data`.
      image_size: square stride-valid input resolution (default 513).
      output_stride: model output stride; GT keypoints live on the
        (image_size-1)/stride + 1 grid.
      scale_factor: scales `image_size`, then snaps it stride-valid.
    """

    def __init__(self, image_dir: str, keypoints_dir: str,
                 image_size: int = 513, output_stride: int = 16,
                 scale_factor: float = 1.0, cache_images: bool = True,
                 num_workers: int = 4, augment_flip: bool = False):
        self.image_dir = image_dir
        self.keypoints_dir = keypoints_dir
        self.augment_flip = augment_flip
        if scale_factor != 1.0:
            # Scale, then snap to the stride-valid grid; the resize in
            # _load_u8 and the GT grid rescale below both derive from the
            # effective image_size, so targets stay aligned.
            image_size = valid_resolution(image_size * scale_factor,
                                          image_size * scale_factor,
                                          output_stride)[0]
        self.image_size = image_size
        self.output_stride = output_stride
        self.scale_factor = scale_factor
        self.num_workers = max(1, num_workers)
        self._cache: Optional[Dict[int, np.ndarray]] = {} if cache_images else None
        self._cache_lock = threading.Lock()

        files = sorted(
            f for f in os.listdir(image_dir)
            if f.lower().endswith(IMAGE_EXTENSIONS))
        # keep only images with prepared GT
        self.files = [
            f for f in files
            if os.path.exists(os.path.join(
                keypoints_dir, os.path.splitext(f)[0],
                os.path.splitext(f)[0] + '_keypoints.txt'))]
        if not self.files:
            raise FileNotFoundError(
                f'no images in {image_dir} with GT under {keypoints_dir}')
        stems = [os.path.splitext(f)[0] for f in self.files]
        kps_xy, _, offs = load_ground_truth_data(
            stems, keypoints_dir, with_heatmaps=False)
        # GT keypoints are stored on the canonical 33x33 grid; rescale them
        # to the output grid R = (image_size-1)/stride + 1. Sentinels
        # ((0,0)/(-1,-1)) are not scaled.
        r = (image_size - 1) // output_stride + 1
        scale = r / HEATMAP_SHAPE[0]
        sentinel = np.all((kps_xy == 0) | (kps_xy == -1), axis=-1,
                          keepdims=True)
        kps_xy = np.where(sentinel, kps_xy, kps_xy * scale)
        offs = np.where(sentinel, offs, offs * scale)
        # (N, 15, 17, 2) (x,y) -> (y,x); sentinels survive the swap.
        self.keypoints = to_yx(kps_xy).astype(np.float32)
        self.offset_vectors = to_yx(offs).astype(np.float32)

    def __len__(self) -> int:
        return len(self.files)

    def __getstate__(self):
        """What a data-parallel rank's process receives: the dataset
        without its lock, and its image cache emptied (each process fills
        its own)."""
        state = dict(self.__dict__)
        del state['_cache_lock']
        if state['_cache'] is not None:
            state['_cache'] = {}
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._cache_lock = threading.Lock()

    def _load_u8(self, idx: int) -> np.ndarray:
        """Decoded + resized RGB uint8 frame (cached after first access)."""
        import cv2

        if self._cache is not None:
            with self._cache_lock:
                cached = self._cache.get(idx)
            if cached is not None:
                return cached
        path = os.path.join(self.image_dir, self.files[idx])
        img = cv2.imread(path)
        if img is None:
            raise IOError(f'could not read {path}')
        img = cv2.resize(img, (self.image_size, self.image_size),
                         interpolation=cv2.INTER_LINEAR)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        if self._cache is not None:
            with self._cache_lock:
                self._cache[idx] = img
        return img

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img = self._load_u8(idx).astype(np.float32)
        img = img * (2.0 / 255.0) - 1.0            # the inference normalization
        return {
            'image': img,                                   # (S, S, 3) NHWC
            'keypoints': self.keypoints[idx],               # (15, 17, 2) y-x grid
            'offset_vectors': self.offset_vectors[idx],     # (15, 17, 2)
            'filename': self.files[idx],
        }

    def _make_batch(self, idxs, pool: Optional[ThreadPoolExecutor],
                    flips: Optional[np.ndarray] = None
                    ) -> Dict[str, np.ndarray]:
        idxs = [int(i) for i in idxs]
        if pool is not None:
            frames = list(pool.map(self._load_u8, idxs))
        else:
            frames = [self._load_u8(i) for i in idxs]
        images = np.stack(frames).astype(np.float32) * (2.0 / 255.0) - 1.0
        keypoints = self.keypoints[idxs]  # advanced indexing -> fresh copy
        if flips is not None and flips.any():
            self._apply_flip(images, keypoints, flips)
        return {
            'image': images,
            'keypoints': keypoints,
            'filenames': [self.files[i] for i in idxs],
        }

    def _apply_flip(self, images: np.ndarray, keypoints: np.ndarray,
                    flips: np.ndarray) -> None:
        """Horizontal-flip augmentation, applied in place to a stacked batch.

        Three coupled transforms:
          1. image x-mirror;
          2. keypoint x-mirror IN THE LOADER'S UNITS: labels are
             x = x_px * R / W, so content at training pixel x_S carries
             label x ~= x_S * R / S, and the pixel mirror
             x_S' = (S-1) - x_S maps labels as x' = R*(S-1)/S - x;
          3. keypoint CHANNEL permutation: left* parts swap with right*
             (constants.LEFT_RIGHT_SWAP).
        Sentinel slots ((0,0) unlabeled / (-1,-1) padding) pass through
        untouched.

        A sample is left UNFLIPPED (label preserved) rather than corrupted
        when any real keypoint would mirror to x' < 0 or exactly onto the
        (0,0) unlabeled sentinel.
        """
        f = np.flatnonzero(flips)
        k = keypoints[f][:, :, LEFT_RIGHT_SWAP, :]
        sentinel = np.all((k == 0) | (k == -1), axis=-1, keepdims=True)
        r = (self.image_size - 1) // self.output_stride + 1
        mirror_max = r * (self.image_size - 1) / self.image_size
        mirrored_x = mirror_max - k[..., 1]
        live = ~sentinel[..., 0]
        bad = np.any(live & ((mirrored_x < 0)
                             | ((k[..., 0] == 0) & (mirrored_x == 0))),
                     axis=(1, 2))
        if bad.any():
            f, k, sentinel = f[~bad], k[~bad], sentinel[~bad]
            mirrored_x = mirrored_x[~bad]
        if f.size == 0:
            return
        images[f] = images[f][:, :, ::-1]
        mirrored = k.copy()
        mirrored[..., 1] = mirrored_x
        keypoints[f] = np.where(sentinel, k, mirrored)

    def iter_batches(self, batch_size: int, shuffle: bool = True,
                     seed: int = 0, drop_remainder: bool = True,
                     prefetch: int = 2, wrap_if_short: bool = False,
                     augment: Optional[bool] = None
                     ) -> Iterator[Dict[str, np.ndarray]]:
        """Epoch iterator yielding stacked numpy batches.

        `prefetch` > 0 assembles batches on a background thread (bounded
        queue, at most `prefetch` batches in flight) while the consumer's
        device step runs; `prefetch=0` is synchronous. `wrap_if_short`
        makes drop_remainder yield ONE wrap-around-padded batch instead of
        zero when the dataset is smaller than `batch_size`.

        With `augment_flip=True` each SLOT in the epoch is flipped with
        probability 1/2, decided by a RNG derived from `seed`, so that a
        (seed, epoch) replays exactly, prefetch on or off. `augment`
        overrides the dataset-level flag per iteration: evaluation passes
        augment=False.
        """
        do_augment = self.augment_flip if augment is None else augment
        order = np.arange(len(self))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        n_items = len(self)
        if wrap_if_short and drop_remainder and 0 < n_items < batch_size:
            order = np.resize(order, batch_size)
            n_items = batch_size
        n = (n_items // batch_size * batch_size if drop_remainder
             else n_items)
        starts = range(0, n, batch_size)
        # Per-slot flip decisions for the whole epoch, fixed up front so
        # that sync and prefetched iteration produce identical batches; the
        # seed is decorrelated from the shuffle stream.
        flip_mask = (np.random.RandomState(seed + 0x5F1B).rand(n) < 0.5
                     if do_augment else None)

        def batch_flips(start):
            return (None if flip_mask is None
                    else flip_mask[start:start + batch_size])

        if prefetch <= 0:
            with ThreadPoolExecutor(self.num_workers) as pool:
                for start in starts:
                    yield self._make_batch(order[start:start + batch_size],
                                           pool, batch_flips(start))
            return

        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        _END = object()
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for start in starts:
                        item = self._make_batch(order[start:start + batch_size],
                                                pool, batch_flips(start))
                        # bounded put that aborts if the consumer went away,
                        # so that this thread cannot block on a full queue
                        while not stop.is_set():
                            try:
                                q.put(item, timeout=0.1)
                                break
                            except queue.Full:
                                continue
                        if stop.is_set():
                            return
                q.put(_END)
            except BaseException as e:  # surfaced on the consumer side
                if not stop.is_set():
                    q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
            t.join()
        finally:
            # Abandoned mid-epoch: unblock and retire the producer + its pool.
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)


def get_dataset_mean_std(dataset: PosenetDataset) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel mean/std over the dataset, accumulated across all items
    and divided once."""
    mean = np.zeros(3, np.float64)
    sq = np.zeros(3, np.float64)
    n = 0
    for i in range(len(dataset)):
        img = dataset[i]['image'].reshape(-1, 3).astype(np.float64)
        mean += img.sum(axis=0)
        sq += (img ** 2).sum(axis=0)
        n += img.shape[0]
    mean /= n
    std = np.sqrt(sq / n - mean ** 2)
    return mean, std
