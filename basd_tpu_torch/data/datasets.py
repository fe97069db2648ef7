"""Data layer: dataset metadata, channel statistics and host-side uint8
arrays; the port of `basd_tpu/data/datasets.py`, numpy only, giving the
same bytes as the JAX package (images, labels and channel stats).

The host produces one uint8 array per image (resized to the raw loader
size); both train views, the crops, flips, TrivialAugment and MixUp/CutMix
run on the device (`basd_tpu_torch.ops`).

  * ``dataset_info``        -- metadata introspection
  * ``get_channel_stats``   -- streaming Welford mean/std over the first
                              5000 train images
  * ``get_subset_indices``  -- OOD class-subset -> parent logit mapping
  * ``load_split_arrays``   -- a split as (N, H, W, 3) uint8 + labels, in
                              RAM when small, else memory-mapped from a
                              disk cache in `.cache/basd_tpu_torch/`
                              (`BASD_DATA_CACHE` moves it)

A builtin registry serves metadata for the datasets the configs name, and
the ``synthetic/*`` family makes learnable datasets procedurally. Other
names go to HuggingFace `datasets` (a local cache or an imagefolder
directory), imported only when such a name is used.
"""

from __future__ import annotations

import os
from functools import lru_cache
from pathlib import Path

import numpy as np

_CHANNEL_STATS_SAMPLES = 5000

# ---------------------------------------------------------------------------
# Builtin metadata registry (serves metadata offline, without HF introspection).
# ---------------------------------------------------------------------------

_BUILTIN_INFO: dict[str, dict] = {
    "uoft-cs/cifar100": {
        "image_key": "img",
        "label_key": "fine_label",
        "num_classes": 100,
        "train_split": "train",
        "eval_split": "test",
        "img_size": 32,
    },
    "uoft-cs/cifar10": {
        "image_key": "img",
        "label_key": "label",
        "num_classes": 10,
        "train_split": "train",
        "eval_split": "test",
        "img_size": 32,
    },
    "ILSVRC/imagenet-1k": {
        "image_key": "image",
        "label_key": "label",
        "num_classes": 1000,
        "train_split": "train",
        "eval_split": "validation",
        "img_size": 224,
    },
    "barkermrl/imagenet-a": {
        "image_key": "image",
        "label_key": "label",
        "num_classes": 200,
        "train_split": "train",
        "eval_split": "test",
        "img_size": 224,
        "subset_of": "ILSVRC/imagenet-1k",
    },
    "songweig/imagenet_sketch": {
        "image_key": "image",
        "label_key": "label",
        "num_classes": 1000,
        "train_split": "train",
        "eval_split": "train",
        "img_size": 224,
        # Sketch re-draws ALL 1000 ImageNet-1k classes (same label space)
        # — identical class set, not a subset.
        "classes_same_as": "ILSVRC/imagenet-1k",
    },
}


def _is_synthetic(name: str) -> bool:
    return name.startswith("synthetic/")


def _parse_synthetic(name: str) -> dict:
    """synthetic/<tag>[-<C>c][-<S>px][-<N>n] e.g. synthetic/cifar10-like."""
    spec = {
        "num_classes": 10,
        "img_size": 16,
        "train_size": 512,
        "eval_size": 128,
    }
    tag = name.split("/", 1)[1]
    if "cifar100" in tag:
        spec.update(num_classes=100, img_size=32)
    elif "cifar10" in tag:
        spec.update(num_classes=10, img_size=32 if "32" in tag else 16)
    for part in tag.split("-"):
        if part.endswith("c") and part[:-1].isdigit():
            spec["num_classes"] = int(part[:-1])
        if part.endswith("px") and part[:-2].isdigit():
            spec["img_size"] = int(part[:-2])
        if part.endswith("n") and part[:-1].isdigit():
            spec["train_size"] = int(part[:-1])
            spec["eval_size"] = max(int(part[:-1]) // 8, 1)
    return spec


def _hf_load_args(dataset_name: str) -> tuple[str, dict]:
    """Resolve a dataset identifier for HF `load_dataset*`.

    Only names that are EXPLICITLY path-like (absolute, or starting with
    `./`/`../`, or containing a path separator beyond the single
    `org/name` hub form) are routed to the local `imagefolder` loader
    (train/val/test subdirs with class-named folders). A bare hub name
    always passes through even if a same-named directory happens to exist
    relative to cwd — a hub dataset must not be silently shadowed."""
    p = Path(dataset_name)
    path_like = (
        p.is_absolute()
        or dataset_name.startswith((".", "~"))
        or dataset_name.count("/") >= 2
    )
    if path_like:
        p = p.expanduser()
        if not p.is_dir():
            raise RuntimeError(
                f"dataset '{dataset_name}' looks like a local path but is "
                f"not a directory"
            )
        return "imagefolder", {"data_dir": str(p)}
    return dataset_name, {}


@lru_cache(maxsize=None)
def dataset_info(dataset_name: str) -> dict:
    """Metadata: image/label keys, class count+names, splits.

    Eval split preference: validation -> test -> train.
    """
    if _is_synthetic(dataset_name):
        spec = _parse_synthetic(dataset_name)
        return {
            "image_key": "image",
            "label_key": "label",
            "num_classes": spec["num_classes"],
            "class_names": tuple(f"class_{i}" for i in range(spec["num_classes"])),
            "class_names_real": True,  # procedural classes ARE the names
            "train_split": "train",
            "eval_split": "test",
            "img_size": spec["img_size"],
            "synthetic": spec,
        }

    if dataset_name in _BUILTIN_INFO:
        base = dict(_BUILTIN_INFO[dataset_name])
        n = base["num_classes"]
        if "class_names" not in base:
            if "subset_of" in base:
                # A true class SUBSET (e.g. ImageNet-A's 200 of 1000)
                # cannot be invented offline: a placeholder would give
                # silently wrong robustness masks. No real metadata -> no
                # class names; `get_subset_indices` raises loudly.
                base["class_names"] = None
            elif "classes_same_as" in base:
                # Identical class set as the parent (e.g. ImageNet-Sketch
                # covers all 1000 ImageNet classes) — share the parent's
                # placeholder names so set-equality holds and masking is
                # correctly skipped, exactly as with real metadata.
                base["class_names"] = dataset_info(
                    base["classes_same_as"]
                )["class_names"]
            else:
                # Placeholder names for a standalone dataset: only ever
                # compared against themselves (marked non-real so subset
                # mapping refuses to trust them).
                base["class_names"] = tuple(
                    f"{dataset_name}:class_{i}" for i in range(n)
                )
                base["class_names_real"] = False
        base.setdefault("class_names_real", "class_names" in _BUILTIN_INFO[dataset_name])
        base.setdefault("synthetic", None)
        return base

    # Last resort: HF metadata introspection — a hub name (needs a local HF
    # cache in this egress-free env) or a LOCAL imagefolder directory
    # (class-named subfolders under split dirs; fully offline).
    try:
        from datasets import ClassLabel, Image, load_dataset, load_dataset_builder

        path, kwargs = _hf_load_args(dataset_name)
        if kwargs:
            # folder datasets only infer features at prepare time; local
            # data, so preparing the arrow dataset is offline and cached
            dsd = load_dataset(path, trust_remote_code=True, **kwargs)
            features = dsd[next(iter(dsd))].features
            splits = set(dsd.keys())
        else:
            meta = load_dataset_builder(path, trust_remote_code=True).info
            features = meta.features
            splits = set(meta.splits.keys())
        image_key = next(n for n, f in features.items() if isinstance(f, Image))
        label_key = next(n for n, f in features.items() if isinstance(f, ClassLabel))
        feat = features[label_key]
        eval_split = (
            "validation" if "validation" in splits
            else "test" if "test" in splits
            else "train"
        )
        return {
            "image_key": image_key,
            "label_key": label_key,
            "num_classes": feat.num_classes,
            "class_names": tuple(feat.names),
            "class_names_real": True,
            "train_split": "train",
            "eval_split": eval_split,
            "img_size": None,
            "synthetic": None,
        }
    except Exception as e:  # pragma: no cover - network-free env
        raise RuntimeError(
            f"dataset '{dataset_name}' is not in the builtin registry and "
            f"could not be introspected via a local HuggingFace cache: {e}"
        ) from e


def get_subset_indices(dataset_name: str, parent_name: str) -> tuple[int, ...] | None:
    """Map OOD-subset class names to parent logit indices (logit masking).

    Returns None when the class sets are identical.

    It REFUSES to invent a subset: when either side lacks real class names
    (offline builtin metadata) and the class sets differ, a hard error is
    raised instead of silently masking the wrong logits — a wrong
    robustness number is worse than no number.
    """
    child = dataset_info(dataset_name)
    parent = dataset_info(parent_name)
    child_names, parent_names = child["class_names"], parent["class_names"]
    if (
        child_names is not None
        and parent_names is not None
        and set(child_names) == set(parent_names)
    ):
        return None
    if (
        child_names is None
        or parent_names is None
        or not child.get("class_names_real", True)
        or not parent.get("class_names_real", True)
    ):
        raise RuntimeError(
            f"class-subset masking for '{dataset_name}' vs '{parent_name}' "
            f"needs REAL class names on both sides, which the offline "
            f"builtin registry cannot provide (e.g. ImageNet-A's actual "
            f"200-of-1000 wnid subset). Point the dataset names at a "
            f"cached HuggingFace dataset or a local imagefolder copy whose "
            f"class directories carry the true wnids."
        )
    parent_map = {name: idx for idx, name in enumerate(parent_names)}
    try:
        return tuple(parent_map[name] for name in child_names)
    except KeyError as e:
        raise RuntimeError(
            f"'{dataset_name}' class {e.args[0]!r} is not a class of "
            f"'{parent_name}' — subset masking needs the child's classes "
            f"to be a subset of the parent's"
        ) from e


# ---------------------------------------------------------------------------
# Synthetic data generation (learnable, deterministic, chunked)
# ---------------------------------------------------------------------------

_SYNTH_CHUNK = 1024


@lru_cache(maxsize=4)
def _synthetic_class_patterns(c: int, s: int) -> np.ndarray:
    """(C, S, S, 3) float32 base pattern per class: distinct spatial
    frequency/phase plus channel rolls, so classes are separable and a
    small model can learn them."""
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
    pats = np.empty((c, s, s, 3), np.float32)
    for k in range(c):
        fx, fy = 1 + (k % 5), 1 + (k // 5) % 5
        phase = 2 * np.pi * (k / max(c, 1))
        base = 0.5 + 0.5 * np.sin(2 * np.pi * (fx * xx + fy * yy) + phase)
        pats[k] = np.stack(
            [base, np.roll(base, k % s, axis=0), np.roll(base, (2 * k) % s, axis=1)],
            axis=-1,
        )
    return pats


def _iter_synthetic_chunks(dataset_name: str, split: str):
    """Yield (images_u8 chunk, labels chunk) without materializing the split.

    Chunked vectorized generation draws the identical RNG stream as a
    per-image loop (labels first, then noise in label order), so output is
    byte-identical regardless of chunk size.
    """
    spec = dataset_info(dataset_name)["synthetic"]
    n = spec["train_size"] if split == "train" else spec["eval_size"]
    c, s = spec["num_classes"], spec["img_size"]
    rng = np.random.default_rng(0 if split == "train" else 1)
    labels = rng.integers(0, c, size=(n,))
    pats = _synthetic_class_patterns(c, s)
    # Chunk rows scale with the RAM limit: generation holds ~4 float64
    # temporaries of chunk size live at peak (noise, sum, *255, clip), so a
    # fixed 1024-row chunk would make writer RSS O(1024 imgs) even under a
    # small _RAM_BYTES_LIMIT — breaking the limit-relative O(chunk) RSS
    # contract the shard-cache test pins. Output bytes are chunk-size
    # independent (see docstring), so this only bounds memory.
    f64_row = s * s * 3 * 8
    rows = int(min(_SYNTH_CHUNK, max(64, _RAM_BYTES_LIMIT // (4 * f64_row))))
    for lo in range(0, n, rows):
        lab = labels[lo : lo + rows]
        img = pats[lab] + rng.normal(0, 0.08, size=(len(lab), s, s, 3))
        yield (
            np.clip(img * 255.0, 0, 255).astype(np.uint8),
            lab.astype(np.int32),
        )


def _synthetic_split_len(dataset_name: str, split: str) -> int:
    spec = dataset_info(dataset_name)["synthetic"]
    return spec["train_size"] if split == "train" else spec["eval_size"]


# ---------------------------------------------------------------------------
# Streaming sample iterator (host side, O(1) memory)
# ---------------------------------------------------------------------------


def iter_split_samples(dataset_name: str, split: str, *, limit: int | None = None):
    """Stream (image_u8 HWC at native size, label) pairs one at a time.

    The host-RAM-bounded access path: nothing is materialized. For HF
    datasets the arrow-backed split decodes rows lazily during iteration.
    """
    count = 0
    if _is_synthetic(dataset_name):
        for imgs, labs in _iter_synthetic_chunks(dataset_name, split):
            for img, lab in zip(imgs, labs):
                if limit is not None and count >= limit:
                    return
                yield img, int(lab)
                count += 1
        return

    info = dataset_info(dataset_name)
    from datasets import load_dataset  # local cache / imagefolder in this env

    path, kwargs = _hf_load_args(dataset_name)
    ds = load_dataset(path, split=split, trust_remote_code=True, **kwargs)
    image_key, label_key = info["image_key"], info["label_key"]
    from PIL import Image as PILImage

    for ex in ds:
        if limit is not None and count >= limit:
            return
        img = ex[image_key]
        if isinstance(img, PILImage.Image):
            img = np.asarray(img.convert("RGB"), dtype=np.uint8)
        else:
            img = np.asarray(img)
            if img.ndim == 2:
                img = np.stack([img] * 3, axis=-1)
        yield img, int(ex[label_key])
        count += 1


# ---------------------------------------------------------------------------
# Array loading (host side). Returns HWC uint8 arrays — in RAM for small
# splits, memory-mapped from an on-disk shard cache for large ones, so peak
# host RSS is O(chunk), never O(split) (ImageNet-1k train at raw 256px is
# ~250 GB).
# ---------------------------------------------------------------------------

_RAM_BYTES_LIMIT = 64 << 20  # splits above this are disk-backed
_DECODE_CHUNK = 512


def _cache_dir() -> Path:
    root = os.environ.get("BASD_DATA_CACHE")
    if root:
        return Path(root)
    return Path(__file__).resolve().parents[2] / ".cache" / "basd_tpu_torch"


def _write_npy_chunked(path, shape, dtype, chunk_iter) -> None:
    """Stream chunks into a .npy file via buffered write() syscalls (page
    cache, not process RSS), then atomically rename into place."""
    path = Path(path)
    # one temporary file per process: ranks that start together each write
    # a whole copy and the last rename wins
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    header = {
        "descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
        "fortran_order": False,
        "shape": tuple(shape),
    }
    written = 0
    with open(tmp, "wb") as f:
        np.lib.format.write_array_header_2_0(f, header)
        for chunk in chunk_iter:
            chunk = np.ascontiguousarray(chunk, dtype=dtype)
            f.write(chunk.tobytes())
            written += len(chunk)
    if written != shape[0]:
        os.unlink(tmp)
        raise RuntimeError(
            f"{path.name}: wrote {written} rows, expected {shape[0]}"
        )
    os.replace(tmp, path)


def _resize_shortest_center_u8(stack: np.ndarray, raw: int) -> np.ndarray:
    """torchvision-style shortest-side Resize(raw) with aspect ratio
    PRESERVED, followed by CenterCrop(raw).

    The stored raw x raw array is the aspect-true center region, so the
    device eval transform (Resize(raw) -> CenterCrop(img),
    `ops/preprocess.py:center_crop_resize`) composes to exactly the chain
    `Resize(raw) + CenterCrop(img)`: raw - img = 2*patch is even, so the
    two nested center crops share the direct crop's offsets. Squashing a
    non-square image to a square here would distort its geometry. The long
    side follows torchvision's `int(raw * long / short)` truncation."""
    from basd_tpu_torch.data.native import resize_batch_u8

    n, h, w, _ = stack.shape
    if h == w:
        return resize_batch_u8(stack, raw, raw)
    if h < w:
        nh, nw = raw, max(raw, int(raw * w / h))
    else:
        nh, nw = max(raw, int(raw * h / w)), raw
    resized = resize_batch_u8(stack, nh, nw)
    oy, ox = (nh - raw) // 2, (nw - raw) // 2
    return np.ascontiguousarray(
        resized[:, oy : oy + raw, ox : ox + raw, :]
    )


def _decode_resize_chunks(dataset_name: str, split: str, raw: int):
    """Yield (chunk_images (k,raw,raw,3) u8, chunk_labels (k,)) — decode in
    chunks, batch same-size images through the native bilinear resize kernel
    (native/basd_host.cpp) instead of a per-image PIL loop. Non-square
    images keep their aspect ratio (shortest-side resize + center crop)."""
    imgs_buf: list[np.ndarray] = []
    labs_buf: list[int] = []

    def flush():
        labs = np.asarray(labs_buf, np.int32)
        out = np.empty((len(imgs_buf), raw, raw, 3), np.uint8)
        # group by native size so each group is one batched native call
        by_size: dict[tuple[int, int], list[int]] = {}
        for i, im in enumerate(imgs_buf):
            by_size.setdefault(im.shape[:2], []).append(i)
        for _, idxs in by_size.items():
            stack = np.stack([imgs_buf[i] for i in idxs])
            out[idxs] = _resize_shortest_center_u8(stack, raw)
        imgs_buf.clear()
        labs_buf.clear()
        return out, labs

    for img, lab in iter_split_samples(dataset_name, split):
        imgs_buf.append(img)
        labs_buf.append(lab)
        if len(imgs_buf) >= _DECODE_CHUNK:
            yield flush()
    if imgs_buf:
        yield flush()


def _split_len(dataset_name: str, split: str) -> int:
    if _is_synthetic(dataset_name):
        return _synthetic_split_len(dataset_name, split)
    from datasets import load_dataset

    path, kwargs = _hf_load_args(dataset_name)
    return len(load_dataset(path, split=split, trust_remote_code=True, **kwargs))


@lru_cache(maxsize=8)
def load_split_arrays(
    dataset_name: str, split: str, img_size: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Load a split as (images_u8 (N,H,W,3), labels (N,)) host arrays.

    Small synthetic splits come back as plain RAM arrays. Anything larger is
    materialized ONCE (chunked decode + native batched resize, bounded RSS)
    into `.cache/basd_tpu_torch/` and returned as read-only memory maps, so epoch
    iteration pages in only the touched batches.

    HF images are host-resized once to ``raw size = round(img_size / 0.875)``
    rounded to a multiple of 4 so on-device crop ops have margin; synthetic
    splits stay at their native size (device ops handle any raw size).
    """
    n = _split_len(dataset_name, split)

    if _is_synthetic(dataset_name):
        s = dataset_info(dataset_name)["synthetic"]["img_size"]
        nbytes = n * s * s * 3
        if nbytes <= _RAM_BYTES_LIMIT:
            chunks = list(_iter_synthetic_chunks(dataset_name, split))
            return (
                np.concatenate([c[0] for c in chunks]),
                np.concatenate([c[1] for c in chunks]),
            )
        raw = s
        chunk_iter = _iter_synthetic_chunks(dataset_name, split)
        tag = f"{split}_{s}px"
    else:
        info = dataset_info(dataset_name)
        target = img_size or info.get("img_size") or 224
        raw = int(round(target / 0.875 / 4.0) * 4)
        chunk_iter = _decode_resize_chunks(dataset_name, split, raw)
        tag = f"{split}_{raw}px"

    cache = _cache_dir() / dataset_name.replace("/", "__")
    cache.mkdir(parents=True, exist_ok=True)
    img_path = cache / f"{tag}.images.npy"
    lab_path = cache / f"{tag}.labels.npy"

    if not (img_path.exists() and lab_path.exists()):
        labels_acc: list[np.ndarray] = []

        def imgs_only():
            for imgs, labs in chunk_iter:
                labels_acc.append(labs)
                yield imgs

        _write_npy_chunked(img_path, (n, raw, raw, 3), np.uint8, imgs_only())
        _write_npy_chunked(lab_path, (n,), np.int32, iter(labels_acc))

    images = np.load(img_path, mmap_mode="r")
    labels = np.asarray(np.load(lab_path))
    if images.shape[0] != n or labels.shape[0] != n:
        raise RuntimeError(
            f"stale data cache for {dataset_name}/{split}: "
            f"{images.shape[0]} rows cached, split has {n}; delete {cache}"
        )
    return images, labels


@lru_cache(maxsize=None)
def get_channel_stats(
    dataset_name: str,
) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """Per-channel mean/std over exactly the first 5000 streamed train
    images at native size, via Welford parallel merge (per-image merge; the
    inner loop runs in the native C++ library, `data.native`). Nothing is
    materialized: O(1) host memory."""
    from basd_tpu_torch.data.native import WelfordStats

    stats = WelfordStats(3)
    for img, _ in iter_split_samples(
        dataset_name, "train", limit=_CHANNEL_STATS_SAMPLES
    ):
        stats.update(img)
    return stats.result()
