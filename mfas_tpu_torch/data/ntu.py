"""NTU RGB+D on the host (port of mfas_tpu/data/ntu.py): the raw dataset,
its parsers and its transforms, in host numpy, shared by the raw-AVI,
packed and resident paths.

  * ``NTU``: cross-subject splits (reference datasets/ntu.py:189-196), AVI
    and skeleton paired by filename stem (a clip without a skeleton is
    dropped with a warning), the subject parsed from chars 9:12 and the
    label from 17:20, the optional bad-skeleton filter (the 302 ids of
    ``bad_skel.txt``), shuffled with its own RandomState(shuffle_seed);
  * ``load_video``: cv2 decode keeping ``vid_len`` linspace frames
    (``legacy_last_frame_zero`` restores the reference's last-slot-zero
    quirk); cv2 is imported inside it, and without cv2 it raises a
    RuntimeError that names pack_ntu;
  * ``get_3D_skeleton``: the .skeleton text format -> (3, T, 25, 2) float32,
    NaNs zeroed (the numpy reference of data/native.py's C++ parser);
  * NormalizeLen: RGB -> vid_len[0] linspace frames; skeleton -> vid_len[1]
    frames by bilinear time interpolation (reference datasets/ntu.py:91-119);
  * CenterCrop (:124-143) and AugCrop (:146-169) temporal crops; AugCrop
    draws from a per-sample RandomState when one is passed;
  * RGB normalization uses the RGB-ordered ImageNet statistics, as the
    reference does on its BGR frames; the skeleton is centred on joint 2 of
    person 1 (:260-275).
"""

from __future__ import annotations

import os

import numpy as np

SPLITS = {
    "train": [1, 4, 8, 13, 15, 16, 17, 18, 19, 25, 27, 28, 31, 34, 35, 38],
    "trainexp": [1, 4, 8, 13, 15, 17, 19],
    "test": [3, 6, 7, 10, 11, 12, 20, 21, 22, 23, 24, 26, 29, 30, 32, 33,
             36, 37, 39, 40],
    "dev": [2, 5, 9, 14],
}

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

_BAD_SKEL_PATH = os.path.join(os.path.dirname(__file__), "bad_skel.txt")


def load_video(path, vid_len=24, legacy_last_frame_zero=False):
    """Decode an AVI and keep vid_len evenly spaced frames
    -> (vid_len, H, W, 3) float32 (BGR, as cv2 decodes)."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "cv2 is required for raw NTU video decode; pre-pack the dataset "
            "with mfas_tpu_torch.tools.pack_ntu on a machine with OpenCV "
            "and pass --packed_datadir") from e

    cap = cv2.VideoCapture(path)
    num_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    video = np.zeros((vid_len, height, width, 3), np.float32)
    if legacy_last_frame_zero:
        taken = set(np.linspace(0, num_frames, vid_len).astype(int).tolist())
    else:
        taken = set(np.linspace(0, max(num_frames - 1, 0),
                                vid_len).astype(int).tolist())
    np_idx = 0
    for fr_idx in range(num_frames):
        ret, frame = cap.read()
        if not ret:
            break
        if fr_idx in taken and np_idx < vid_len:
            video[np_idx] = frame.astype(np.float32)
            np_idx += 1
    cap.release()
    return video


def get_3D_skeleton(path):
    """Parse the NTU .skeleton text format -> (3, T, 25, 2) float32: per
    frame a person count, then per person an info line, a joint-count line
    and 25 joint lines whose first three floats are x, y, z. Persons past
    the second are dropped; NaNs become 0."""
    with open(path) as f:
        lines = [ln.strip() for ln in f]

    num_frames = int(lines[0])
    out = np.zeros((3, num_frames, 25, 2), np.float32)
    i = 1
    for t in range(num_frames):
        nb_person = int(lines[i])
        for p in range(nb_person):
            i += 2  # person info line + joint-count line
            for j in range(25):
                i += 1
                if p < 2:
                    xyz = lines[i].split(" ")[:3]
                    out[0, t, j, p] = float(xyz[0])
                    out[1, t, j, p] = float(xyz[1])
                    out[2, t, j, p] = float(xyz[2])
        i += 1
    return np.nan_to_num(out)


def interp_time_plan(T, out_len):
    """The (lo, hi, w) gather plan of the bilinear time resample: out[t] =
    in[lo[t]]*(1-w[t]) + in[hi[t]]*w[t]. Shared by the host interpolation
    and the resident device path, so both resample identically."""
    if T == out_len:
        idx = np.arange(out_len)
        return idx, idx, np.zeros(out_len, np.float32)
    scale = T / out_len
    pos = (np.arange(out_len, dtype=np.float64) + 0.5) * scale - 0.5
    pos = np.clip(pos, 0.0, T - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, T - 1)
    w = (pos - lo).astype(np.float32)
    return lo, hi, w


def linspace_frame_idx(num, out_len):
    """NormalizeLen's RGB frame pick (reference datasets/ntu.py:99-102)."""
    return np.linspace(0, num - 1, out_len).astype(int)


def interpolate_skeleton_time(skel, out_len):
    """(C, T, V, M) -> (C, out_len, V, M), bilinear over time with
    half-pixel centers (torch F.interpolate align_corners=False)."""
    T = skel.shape[1]
    if T == out_len:
        return skel.astype(np.float32)
    lo, hi, w = interp_time_plan(T, out_len)
    data = skel.astype(np.float32)
    return (data[:, lo] * (1.0 - w)[None, :, None, None]
            + data[:, hi] * w[None, :, None, None])


# --------------------------------------------------------------------------
# transforms (sample = {'rgb', 'ske', 'label'})
# --------------------------------------------------------------------------
class NormalizeLen:
    def __init__(self, vid_len=(8, 32)):
        self.vid_len = vid_len

    def __call__(self, sample):
        rgb, skel = sample["rgb"], sample["ske"]
        if rgb.shape[0] != 1:
            rgb = rgb[linspace_frame_idx(len(rgb), self.vid_len[0])]
        if skel.shape[0] != 1:
            skel = interpolate_skeleton_time(skel, self.vid_len[1])
        return {"rgb": rgb, "ske": skel, "label": sample["label"]}


class CenterCrop:
    """Symmetric temporal crop keeping p_interval of the sequence."""

    def __init__(self, p_interval=0.9):
        self.p_interval = p_interval

    def __call__(self, sample):
        rgb, skel = sample["rgb"], sample["ske"]
        if skel.shape[0] != 1:
            valid = skel.shape[1]
            bias = int((1 - self.p_interval) * valid / 2)
            skel = skel[:, bias:valid - bias]
        if rgb.shape[0] != 1:
            num = len(rgb)
            bias = int((1 - self.p_interval) * num / 2)
            rgb = rgb[bias:num - bias]
        return {"rgb": rgb, "ske": skel, "label": sample["label"]}


class AugCrop:
    """Random temporal crop: RGB keeps a centered random fraction, skeleton
    keeps a random window of >=64 frames."""

    accepts_rng = True   # per-sample RNG protocol (Compose/getitem_seeded)

    def __init__(self, p_interval=0.5, seed=0):
        self.p_interval = p_interval
        self.rng = np.random.RandomState(seed)

    def __call__(self, sample, rng=None):
        r = rng if rng is not None else self.rng
        rgb, skel = sample["rgb"], sample["ske"]
        ratio = 1.0 - self.p_interval * r.rand()
        if rgb.shape[0] != 1:
            num = len(rgb)
            begin = (num - int(num * ratio)) // 2
            rgb = rgb[begin:num - begin]
        if skel.shape[0] != 1:
            valid = skel.shape[1]
            p = float(r.rand(1)[0]) * (1.0 - self.p_interval) + self.p_interval
            cropped = int(np.minimum(np.maximum(int(np.floor(valid * p)), 64),
                                     valid))
            bias = r.randint(0, valid - cropped + 1)
            skel = skel[:, bias:bias + cropped]
        return {"rgb": rgb, "ske": skel, "label": sample["label"]}


class Compose:
    # forwards a per-sample rng to the members that accept it
    accepts_rng = True

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, sample, rng=None):
        for t in self.transforms:
            if rng is not None and getattr(t, "accepts_rng", False):
                sample = t(sample, rng=rng)
            else:
                sample = t(sample)
        return sample


def normalize_modalities(rgb, skel, modality="both", no_norm=False):
    """RGB /255 + ImageNet mean/std; skeleton centred on joint 2 of person
    1 (reference datasets/ntu.py:260-275)."""
    if modality in ("rgb", "both"):
        rgb = rgb / 255.0
        rgb = ((rgb - IMAGENET_MEAN.reshape(1, 1, 1, 3))
               / IMAGENET_STD.reshape(1, 1, 1, 3))
    if modality in ("skeleton", "both") and not no_norm:
        origin = skel[:, :, 1, 0]
        skel = skel - origin[:, :, None, None]
    return rgb, skel


def load_bad_skeleton_ids():
    with open(_BAD_SKEL_PATH) as f:
        return [ln.strip() for ln in f if ln.strip()]


def apply_transform(transform, sample, rng):
    """``transform(sample)``, with the per-sample ``rng`` passed to a
    transform that speaks the per-sample-seeded protocol."""
    if rng is not None and getattr(transform, "accepts_rng", False):
        return transform(sample, rng=rng)
    return transform(sample)


class NTU:
    """The raw NTU layout (``nturgbd_rgb/avi_{dim}x{dim}_{fr}/*.avi`` and
    ``nturgbd_skeletons/*.skeleton``) as an indexable dataset of
    {'rgb', 'ske', 'label'} numpy samples."""

    def __init__(self, root_dir="", transform=None, stage="train",
                 vid_len=(8, 32), vid_dim=256, vid_fr=30, args=None,
                 shuffle_seed=0):
        subjects = SPLITS[stage]
        basename_rgb = os.path.join(
            root_dir, "nturgbd_rgb/avi_{0}x{0}_{1}".format(vid_dim, vid_fr))
        basename_ske = os.path.join(root_dir, "nturgbd_skeletons")

        # frame resampling is NormalizeLen's job (load_video decodes its
        # default 24); vid_len is kept for the reference's signature
        self.vid_len = vid_len
        self.transform = transform
        self.root_dir = root_dir
        self.stage = stage
        self.args = args

        rgb_files = sorted(os.listdir(basename_rgb))
        ske_files = sorted(os.listdir(basename_ske))
        # paired by filename stem, not by sorted position: the official
        # skeleton release omits clips the RGB release has, and zipping the
        # two listings would cross-pair every later clip
        rgb_by_stem = {f[:20]: os.path.join(basename_rgb, f)
                       for f in rgb_files
                       if f.split(".")[-1] == "avi"
                       and int(f[9:12]) in subjects}
        ske_by_stem = {f[:20]: os.path.join(basename_ske, f)
                       for f in ske_files
                       if f.split(".")[-1] == "skeleton"
                       and int(f[9:12]) in subjects}
        stems = sorted(rgb_by_stem)
        unpaired = [s for s in stems if s not in ske_by_stem]
        if unpaired:
            print(f"WARNING: {len(unpaired)} {stage} clips have no "
                  f".skeleton pair (first: {unpaired[0]}) — dropped "
                  "(pairing is by filename stem; the positional pairing "
                  "the reference uses would silently cross-pair)")
            stems = [s for s in stems if s in ske_by_stem]
        self.rgb_list = [rgb_by_stem[s] for s in stems]
        self.ske_list = [ske_by_stem[s] for s in stems]
        self.labels = [int(s[17:20]) for s in stems]

        if args is not None and getattr(args, "no_bad_skel", False):
            for sid in load_bad_skeleton_ids():
                p = os.path.join(basename_ske, sid + ".skeleton")
                if p in self.ske_list:
                    i = self.ske_list.index(p)
                    self.ske_list.pop(i)
                    self.rgb_list.pop(i)
                    self.labels.pop(i)

        # the reference shuffles with the global RNG at construction
        # (datasets/ntu.py:225); a dedicated seed has the same effect
        perm = np.random.RandomState(shuffle_seed).permutation(
            len(self.labels))
        self.rgb_list = [self.rgb_list[i] for i in perm]
        self.ske_list = [self.ske_list[i] for i in perm]
        self.labels = [self.labels[i] for i in perm]

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx):
        return self._get(idx)

    def getitem_seeded(self, idx, seed):
        """Per-sample-seeded fetch (MapLoader protocol): random transforms
        draw from a private RandomState(seed), whatever the thread
        schedule."""
        return self._get(idx, rng=np.random.RandomState(seed))

    def _get(self, idx, rng=None):
        modality = getattr(self.args, "modality", "both") if self.args \
            else "both"
        no_norm = getattr(self.args, "no_norm", False) if self.args else False

        video = np.zeros([1], np.float32)
        skeleton = np.zeros([1], np.float32)
        if modality in ("rgb", "both"):
            video = load_video(self.rgb_list[idx])
        if modality in ("skeleton", "both"):
            skeleton = get_3D_skeleton(self.ske_list[idx])

        video, skeleton = normalize_modalities(video, skeleton, modality,
                                               no_norm)
        sample = {"rgb": video, "ske": skeleton, "label": self.labels[idx] - 1}
        if self.transform:
            sample = apply_transform(self.transform, sample, rng)
        sample["label"] = np.int32(sample["label"])
        sample["rgb"] = np.asarray(sample["rgb"], np.float32)
        sample["ske"] = np.asarray(sample["ske"], np.float32)
        return sample
