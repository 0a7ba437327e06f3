"""Offline preprocessing: keypoint-annotated cat photos -> rotation-
normalized, augmented 64x64 face crops. A copy of
``catgen/data/offline.py`` (numpy and PIL only), catgen's Python-3
rebuild of the reference's ``dataset/generate_dataset.py``: keypoint
parsing, eyeline rotation removal, face-rectangle method 4, median-padded
extraction, and the 9x augmentation set (hflip, equal-axis scale
0.93-1.08, rotation +-8 deg, translation +-4 px, multiplicative
brightness +-15%, gaussian noise sigma 0.02).

Affine warps run through PIL with analytic keypoint transforms, and
images are processed in a process pool. The same corpus and seed give
the same files, byte for byte, as catgen's.

Output contract: JPEGs named ``{img_idx:06d}_{aug_idx:03d}.jpg`` in
``out_unaug_64x64`` (originals only) and ``out_aug_64x64`` (all), which
the train-time loader reads.
"""

from __future__ import annotations

import math
import os
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

# keypoint indices (dataset.py:382-405); (y, x) order, 9 points
LEFT_EYE, RIGHT_EYE, MOUTH = 0, 1, 2
LEFT_EAR_1, LEFT_EAR_2, LEFT_EAR_3 = 3, 4, 5
RIGHT_EAR_1, RIGHT_EAR_2, RIGHT_EAR_3 = 6, 7, 8
# fliplr point swaps (dataset.py:564-578)
_FLIP_SWAPS = [(RIGHT_EAR_3, LEFT_EAR_1), (RIGHT_EAR_2, LEFT_EAR_2),
               (RIGHT_EAR_1, LEFT_EAR_3), (RIGHT_EYE, LEFT_EYE)]


def parse_cat_file(path: str, image_height: int,
                   image_width: int) -> np.ndarray:
    """Parses a ``<img>.cat`` keypoint file -> (9, 2) int array in (y, x)
    order (dataset.py:71-92: first token is the point count, then x y
    pairs; values abs()-ed and clipped into the image)."""
    with open(path, "r") as f:
        tokens = f.readline().strip().split()
    vals = [abs(int(t)) for t in tokens]
    n = vals[0]
    assert n == 9, f"{path}: expected 9 keypoints, header says {n}"
    pts = np.zeros((9, 2), np.int64)
    for i in range(9):
        x = min(max(vals[1 + 2 * i], 0), image_width - 1)
        y = min(max(vals[2 + 2 * i], 0), image_height - 1)
        pts[i] = (y, x)
    return pts


def eyeline_angle_deg(keypoints: np.ndarray) -> float:
    """Angle of the left->right eye vector vs the x axis, degrees, signed
    by dy (dataset.py:489-508, angle_between:944-967)."""
    dy = float(keypoints[RIGHT_EYE, 0]) - float(keypoints[LEFT_EYE, 0])
    dx = float(keypoints[RIGHT_EYE, 1]) - float(keypoints[LEFT_EYE, 1])
    return math.degrees(math.atan2(dy, dx))


def _affine_warp(image: np.ndarray, forward: np.ndarray,
                 resample=None) -> np.ndarray:
    """Warps HWC uint8 ``image`` with the *forward* 3x3 xy matrix using
    PIL. The reference warps with skimage ``mode="nearest"`` (edge
    replicate, dataset.py:173); PIL's AFFINE fills out-of-range with
    black, so we edge-pad the source by the worst-case displacement,
    shift the transform into padded coordinates, and crop back."""
    from PIL import Image

    h, w = image.shape[:2]
    pad = max(h, w) // 2 + 2
    padded = np.pad(image, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
    # shift: padded coords p' = p + pad; out' = T(out) + pad
    shift = np.array([[1, 0, pad], [0, 1, pad], [0, 0, 1]], float)
    fwd_p = shift @ forward @ np.linalg.inv(shift)
    inv = np.linalg.inv(fwd_p)
    im = Image.fromarray(padded)
    resample = resample or Image.BILINEAR
    out = im.transform(im.size, Image.AFFINE,
                       data=(inv[0, 0], inv[0, 1], inv[0, 2],
                             inv[1, 0], inv[1, 1], inv[1, 2]),
                       resample=resample)
    return np.asarray(out)[pad:pad + h, pad:pad + w]


def _transform_points(keypoints: np.ndarray, forward: np.ndarray,
                      height: int, width: int) -> np.ndarray:
    """Applies the forward xy matrix to (y,x) keypoints, clipping into the
    image (the reference leaves out-of-image points unchanged,
    dataset.py:788-796; we clip — affects only degenerate crops)."""
    xy = np.stack([keypoints[:, 1], keypoints[:, 0],
                   np.ones(len(keypoints))], axis=1).astype(np.float64)
    out = xy @ forward.T
    x = np.clip(np.rint(out[:, 0]), 0, width - 1)
    y = np.clip(np.rint(out[:, 1]), 0, height - 1)
    return np.stack([y, x], axis=1).astype(np.int64)


@dataclass
class FaceImage:
    """image (H,W,3) uint8 + keypoints (9,2) int (y,x) — the
    ImageWithKeypoints equivalent."""
    image: np.ndarray
    keypoints: np.ndarray

    @property
    def height(self) -> int:
        return self.image.shape[0]

    @property
    def width(self) -> int:
        return self.image.shape[1]

    def copy(self) -> "FaceImage":
        return FaceImage(self.image.copy(), self.keypoints.copy())

    # -- rotation removal (dataset.py:152-189) -------------------------

    def remove_rotation(self) -> None:
        angle = math.radians(eyeline_angle_deg(self.keypoints))
        ec_y = (self.keypoints[LEFT_EYE, 0] + self.keypoints[RIGHT_EYE, 0]) // 2
        ec_x = (self.keypoints[LEFT_EYE, 1] + self.keypoints[RIGHT_EYE, 1]) // 2
        cy, cx = self.height // 2, self.width // 2
        c, s = math.cos(-angle), math.sin(-angle)
        to_tl = np.array([[1, 0, -ec_x], [0, 1, -ec_y], [0, 0, 1]], float)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], float)
        to_c = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1]], float)
        forward = to_c @ rot @ to_tl
        self.image = _affine_warp(self.image, forward)
        self.keypoints = _transform_points(self.keypoints, forward,
                                           self.height, self.width)

    # -- face rectangle (dataset.py:602-676) ---------------------------

    def _face_center(self) -> Tuple[int, int]:
        ys = self.keypoints[[LEFT_EYE, RIGHT_EYE, MOUTH], 0]
        xs = self.keypoints[[LEFT_EYE, RIGHT_EYE, MOUTH], 1]
        return int(ys.mean()), int(xs.mean())

    def face_rectangle(self, method: int = 4) -> Tuple[int, int, int, int]:
        """(tl_y, tl_x, br_y, br_x) per the reference's methods 0-4."""
        h, w = self.height, self.width
        fc_y, fc_x = self._face_center()
        kp = self.keypoints

        def rect0():
            return (int(kp[:, 0].min()), int(kp[:, 1].min()),
                    int(kp[:, 0].max()), int(kp[:, 1].max()))

        if method == 0:
            return rect0()
        if method in (1, 2):
            tl_y, tl_x, br_y, br_x = rect0()
            rc_y = tl_y + (br_y - tl_y) // 2
            rc_x = tl_x + (br_x - tl_x) // 2
            dy, dx = fc_y - rc_y, fc_x - rc_x
            if method == 2:
                dy, dx = dy / 2, dx / 2
            return (int(max(0, tl_y + dy)), int(max(0, tl_x + dx)),
                    int(min(h - 1, br_y + dy)), int(min(w - 1, br_x + dx)))
        if method == 3:
            r0 = rect0()
            r2 = self.face_rectangle(2)
            return (max(0, min(r0[0], r2[0])), max(0, min(r0[1], r2[1])),
                    min(h - 1, max(r0[2], r2[2])),
                    min(w - 1, max(r0[3], r2[3])))
        if method == 4:
            tl_y, tl_x, br_y, br_x = self.face_rectangle(3)
            # Rectangle.square (dataset.py:853-910): shrink the longer side
            # symmetrically (odd overflow removed from the top/left)
            height, width = br_y - tl_y, br_x - tl_x
            if height > width:
                diff = height - width
                tl_y += diff // 2 + (diff % 2)
                br_y -= diff // 2
            elif width > height:
                diff = width - height
                tl_x += diff // 2 + (diff % 2)
                br_x -= diff // 2
            return (tl_y, tl_x, br_y, br_x)
        raise ValueError(f"unknown rectangle method {method}")

    # -- extraction (dataset.py:191-239) -------------------------------

    def extract_face(self, pad: int = 30) -> "FaceImage":
        tl_y, tl_x, br_y, br_x = self.face_rectangle(4)
        h, w = self.height, self.width
        pb_top = max(0, pad - tl_y)
        pb_left = max(0, pad - tl_x)
        pb_bottom = max(0, (br_y + pad) - (h - 1))
        pb_right = max(0, (br_x + pad) - (w - 1))
        y0 = max(0, tl_y - pad)
        x0 = max(0, tl_x - pad)
        y1 = min(h - 1, br_y + pad)
        x1 = min(w - 1, br_x + pad)
        crop = self.image[y0:y1 + 1, x0:x1 + 1]
        kp = self.keypoints.copy()
        kp[:, 0] = np.clip(kp[:, 0] - y0, 0, crop.shape[0] - 1)
        kp[:, 1] = np.clip(kp[:, 1] - x0, 0, crop.shape[1] - 1)
        if pb_top or pb_bottom or pb_left or pb_right:
            crop = np.pad(crop, ((pb_top, pb_bottom), (pb_left, pb_right),
                                 (0, 0)), mode="median")
            kp[:, 0] += pb_top
            kp[:, 1] += pb_left
        return FaceImage(crop, kp)

    def unpad(self, pad: int) -> None:
        self.image = self.image[pad:self.height - pad,
                                pad:self.width - pad]
        self.keypoints[:, 0] = np.clip(self.keypoints[:, 0] - pad, 0,
                                       self.height - 1)
        self.keypoints[:, 1] = np.clip(self.keypoints[:, 1] - pad, 0,
                                       self.width - 1)

    def resize(self, new_height: int, new_width: int) -> None:
        from PIL import Image

        h, w = self.height, self.width
        im = Image.fromarray(self.image).resize((new_width, new_height),
                                                Image.BILINEAR)
        self.image = np.asarray(im)
        self.keypoints = np.stack([
            np.clip(self.keypoints[:, 0] * new_height // max(h, 1), 0,
                    new_height - 1),
            np.clip(self.keypoints[:, 1] * new_width // max(w, 1), 0,
                    new_width - 1)], axis=1)

    def fliplr(self) -> None:
        self.image = np.fliplr(self.image).copy()
        self.keypoints[:, 1] = (self.width - 1) - self.keypoints[:, 1]
        for a, b in _FLIP_SWAPS:
            self.keypoints[[a, b]] = self.keypoints[[b, a]]

    # -- augmentation (dataset.py:241-311; ImageAugmenter.py:35-192) ---

    def augment(self, n: int, rng: np.random.RandomState,
                hflip: bool = True,
                scale_range: Tuple[float, float] = (0.93, 1.08),
                rotation_deg: float = 8.0, shear_deg: float = 0.0,
                translation_px: int = 4, brightness_change: float = 0.15,
                noise_std: float = 0.02) -> List["FaceImage"]:
        out = []
        h, w = self.height, self.width
        cy, cx = h // 2, w // 2
        for _ in range(n):
            img = self.copy()
            if hflip and rng.rand() > 0.5:
                img.fliplr()
            # multiplicative brightness + additive gaussian noise
            arr = img.image.astype(np.float64)
            arr = arr * rng.uniform(1.0 - brightness_change,
                                    1.0 + brightness_change)
            if noise_std > 0:
                arr = arr + 255.0 * rng.normal(0.0, noise_std, arr.shape)
            img.image = np.clip(arr, 0, 255).astype(np.uint8)
            # affine: to-topleft . (scale, rot, shear, trans) . to-center
            scale = rng.uniform(*scale_range)
            angle = math.radians(rng.uniform(-rotation_deg, rotation_deg))
            shear = math.radians(rng.uniform(-shear_deg, shear_deg)) \
                if shear_deg else 0.0
            tx = rng.randint(-translation_px, translation_px + 1) \
                if translation_px else 0
            ty = rng.randint(-translation_px, translation_px + 1) \
                if translation_px else 0
            c, s = math.cos(angle), math.sin(angle)
            to_tl = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], float)
            tf = np.array([
                [scale * c, -scale * math.sin(angle + shear), tx],
                [scale * s, scale * math.cos(angle + shear), ty],
                [0, 0, 1]], float)
            to_c = np.array([[1, 0, cx], [0, 1, cy], [0, 0, 1]], float)
            forward = to_c @ tf @ to_tl
            img.image = _affine_warp(img.image, forward)
            img.keypoints = _transform_points(img.keypoints, forward, h, w)
            out.append(img)
        return out


# ---------------------------------------------------------------------------
# debug drawing (dataset.py:313-372, ImageAugmenter.py:647-738) — overlay
# renderers for eyeballing the keypoint/rect pipeline. The reference shows
# these in matplotlib windows; here they are pure-numpy PNG writers behind
# ``generate_dataset --debug-draw N``.
# ---------------------------------------------------------------------------

# rect-method outline colors (dataset.py:335-347): green/blue/red/yellow/
# cyan for methods 0-4
RECT_COLORS = {0: (0, 255, 0), 1: (0, 0, 255), 2: (255, 0, 0),
               3: (255, 255, 0), 4: (0, 255, 255)}


def draw_points(image: np.ndarray, keypoints: np.ndarray,
                color: Tuple[int, int, int] = (255, 0, 0)) -> None:
    """Draws 3-px crosses at (y, x) keypoints, in place
    (dataset.py:352-365)."""
    h, w = image.shape[:2]
    for y, x in keypoints:
        y, x = int(y), int(x)
        image[y, max(0, x - 1):min(w - 1, x + 2)] = color
        image[max(0, y - 1):min(h - 1, y + 2), x] = color


def draw_rectangle(image: np.ndarray, rect: Tuple[int, int, int, int],
                   color: Tuple[int, int, int]) -> None:
    """Draws a 1-px rectangle outline (tl_y, tl_x, br_y, br_x), in place
    (dataset.py:321-331); coordinates clipped into the image."""
    h, w = image.shape[:2]
    tl_y = int(np.clip(rect[0], 0, h - 1))
    tl_x = int(np.clip(rect[1], 0, w - 1))
    br_y = int(np.clip(rect[2], 0, h - 1))
    br_x = int(np.clip(rect[3], 0, w - 1))
    image[tl_y, tl_x:br_x + 1] = color
    image[br_y, tl_x:br_x + 1] = color
    image[tl_y:br_y + 1, tl_x] = color
    image[tl_y:br_y + 1, br_x] = color


def debug_overlay(face: FaceImage) -> np.ndarray:
    """Keypoint crosses + all five face-rectangle methods drawn over a
    copy of the image (draw_face_rectangles, dataset.py:335-347)."""
    img = face.image.copy()
    for method, color in RECT_COLORS.items():
        draw_rectangle(img, face.face_rectangle(method), color)
    draw_points(img, face.keypoints)
    return img


def augmentation_sheet(faces: Sequence[FaceImage], cols: int = 5,
                       draw_kp: bool = True) -> np.ndarray:
    """Tiles augmented variants into one contact sheet (the
    ImageAugmenter.plot_images grid, ImageAugmenter.py:647-738), with
    keypoint crosses so warp/keypoint agreement is visible per tile."""
    assert faces, "need at least one face"
    h = max(f.height for f in faces)
    w = max(f.width for f in faces)
    rows = (len(faces) + cols - 1) // cols
    sheet = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, f in enumerate(faces):
        tile = f.image.copy()
        if draw_kp:
            draw_points(tile, f.keypoints)
        r, c = divmod(i, cols)
        sheet[r * h:r * h + f.height, c * w:c * w + f.width] = tile
    return sheet


def write_debug_draws(path: str, img_idx: int, out_dir: str,
                      padding: int = 30, augmentations: int = 9,
                      seed: int = 42) -> List[str]:
    """Runs the pipeline stages for one image and writes the overlay
    PNGs: raw keypoints+rects, rotation-removed, extracted crop, and the
    augmentation contact sheet. Returns the written paths."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed + img_idx)
    face = load_face_image(path)
    stages = [("raw", debug_overlay(face))]
    face.remove_rotation()
    stages.append(("derot", debug_overlay(face)))
    face = face.extract_face(pad=padding)
    stages.append(("crop", debug_overlay(face)))
    augs = face.augment(augmentations, rng)
    stages.append(("augs", augmentation_sheet([face] + augs)))
    written = []
    for name, arr in stages:
        out = os.path.join(out_dir, f"{img_idx:06d}_{name}.png")
        Image.fromarray(arr).save(out)
        written.append(out)
    return written


# ---------------------------------------------------------------------------
# corpus scan and the whole pipeline (generate_dataset.py:31-91)
# ---------------------------------------------------------------------------

CAT_SUBDIRS = ["CAT_00", "CAT_01", "CAT_02", "CAT_03", "CAT_04", "CAT_05",
               "CAT_06"]


def scan_corpus(root: str,
                subdirs: Optional[Sequence[str]] = None) -> List[str]:
    """Image paths that have a sibling .cat keypoint file
    (dataset.py:57-69)."""
    subdirs = subdirs if subdirs is not None else CAT_SUBDIRS
    paths = []
    for sd in subdirs:
        d = os.path.join(root, sd)
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            p = os.path.join(d, name)
            if re.match(r".*\.jpg$", name) and os.path.isfile(p + ".cat"):
                paths.append(p)
    return paths


def load_face_image(path: str) -> FaceImage:
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"))
    kp = parse_cat_file(path + ".cat", arr.shape[0], arr.shape[1])
    return FaceImage(arr, kp)


def process_one(path: str, img_idx: int, out_unaug: Optional[str],
                out_aug: Optional[str], padding: int = 30,
                augmentations: int = 9, scale: int = 64,
                seed: int = 42) -> int:
    """Full per-image pipeline (generate_dataset.py:44-91). Returns the
    number of files written."""
    from PIL import Image

    rng = np.random.RandomState(seed + img_idx)
    face = load_face_image(path)
    face.remove_rotation()
    face_orig = face.extract_face(pad=padding)
    faces = [face_orig] + face_orig.augment(augmentations, rng)
    written = 0
    for aug_idx, f in enumerate(faces):
        f.unpad(padding)
        f.resize(scale, scale)
        filename = f"{img_idx:06d}_{aug_idx:03d}.jpg"
        img = Image.fromarray(f.image)
        if out_unaug and aug_idx == 0:
            img.save(os.path.join(out_unaug, filename), quality=95)
            written += 1
        if out_aug:
            img.save(os.path.join(out_aug, filename), quality=95)
            written += 1
    return written


def generate_dataset(root: str, out_dir: str = ".", padding: int = 30,
                     augmentations: int = 9, scale: int = 64,
                     workers: int = 0, seed: int = 42,
                     subdirs: Optional[Sequence[str]] = None) -> Tuple[int, int]:
    """Runs the full offline pipeline. Returns (n_images, n_written)."""
    out_unaug = os.path.join(out_dir, f"out_unaug_{scale}x{scale}")
    out_aug = os.path.join(out_dir, f"out_aug_{scale}x{scale}")
    os.makedirs(out_unaug, exist_ok=True)
    os.makedirs(out_aug, exist_ok=True)
    paths = scan_corpus(root, subdirs)
    if not paths:
        raise FileNotFoundError(
            f"no .jpg with sibling .cat files under {root}")
    args = [(p, i, out_unaug, out_aug, padding, augmentations, scale, seed)
            for i, p in enumerate(paths)]
    if workers and workers > 1:
        import multiprocessing as mp

        # spawned workers: a forked copy of a process with threads (torch's
        # pools) may deadlock
        with mp.get_context("spawn").Pool(workers) as pool:
            counts = pool.starmap(process_one, args)
    else:
        counts = [process_one(*a) for a in args]
    return len(paths), sum(counts)
