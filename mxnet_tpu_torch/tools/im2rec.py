"""Image folders to record files: the port's copy of ``tools/im2rec.py``
(reference: tools/im2rec.py).

``python -m mxnet_tpu_torch.tools.im2rec PREFIX ROOT --list`` writes
``PREFIX.lst`` (``index\\tlabel\\trelpath``, a label a sub-folder of
``ROOT``, shuffled with seed 100 unless ``--shuffle 0``; ``--chunks`` and
``--train-ratio`` split it); without ``--list`` it packs the images of
``PREFIX.lst`` into ``PREFIX.rec`` and ``PREFIX.idx`` (JPEG at
``--quality``, the shorter side scaled to ``--resize``; ``--pack-label``
keeps a detection list's whole label vector).  Decoding and encoding
use cv2, else PIL.
"""

import argparse
import os
import random

import numpy as np

from ..image import _imdecode_np, imresize
from ..recordio import IRHeader, MXIndexedRecordIO, pack_img

EXTS = (".jpg", ".jpeg", ".png")


def make_list(args):
    image_list = []
    label = 0
    labels = {}
    for root, dirs, files in os.walk(args.root):
        dirs.sort()
        cat = os.path.relpath(root, args.root)
        for f in sorted(files):
            if f.lower().endswith(EXTS):
                if cat not in labels:
                    labels[cat] = label
                    label += 1
                image_list.append((os.path.join(cat, f), labels[cat]))
    if args.shuffle:
        random.seed(100)
        random.shuffle(image_list)
    n_total = len(image_list)
    chunk = n_total // args.chunks
    for c in range(args.chunks):
        suffix = "" if args.chunks == 1 else "_%d" % c
        part = image_list[c * chunk:(c + 1) * chunk
                          if c + 1 < args.chunks else n_total]
        n_train = int(len(part) * args.train_ratio)
        splits = [("train", part[:n_train]), ("val", part[n_train:])] \
            if args.train_ratio < 1.0 else [("", part)]
        for split_name, items in splits:
            tag = (suffix + "_" + split_name) if split_name else suffix
            path = args.prefix + tag + ".lst"
            with open(path, "w") as f:
                for i, (rel, lab) in enumerate(items):
                    f.write("%d\t%f\t%s\n" % (i, lab, rel))
            print("wrote", path, len(items), "items")


def read_list(path, pack_label=False):
    """``(index, label, relpath)`` of each line of a ``.lst`` file: the
    label the scalar of column 1, or with ``pack_label`` the float vector
    of the middle columns."""
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            if pack_label:
                label = np.array(parts[1:-1], dtype=np.float32)
            else:
                label = float(parts[1])
            yield int(parts[0]), label, parts[-1]


def im2rec(args):
    rec = MXIndexedRecordIO(args.prefix + ".idx", args.prefix + ".rec", "w")
    n = 0
    for idx, label, rel in read_list(args.prefix + ".lst",
                                     pack_label=args.pack_label):
        with open(os.path.join(args.root, rel), "rb") as f:
            arr = _imdecode_np(f.read())
        if args.resize:
            h, w = arr.shape[:2]
            scale = args.resize / min(w, h)
            arr = imresize(arr, int(w * scale), int(h * scale))
        rec.write_idx(idx, pack_img(IRHeader(0, label, idx, 0),
                                    np.asarray(arr), quality=args.quality))
        n += 1
    rec.close()
    print("wrote %s.rec (%d records)" % (args.prefix, n))


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="create RecordIO image datasets")
    parser.add_argument("prefix", help="output prefix (or .lst prefix)")
    parser.add_argument("root", help="image root directory")
    parser.add_argument("--list", action="store_true")
    parser.add_argument("--shuffle", type=int, default=1)
    parser.add_argument("--chunks", type=int, default=1)
    parser.add_argument("--train-ratio", type=float, default=1.0)
    parser.add_argument("--resize", type=int, default=0)
    parser.add_argument("--quality", type=int, default=95)
    parser.add_argument("--pack-label", action="store_true",
                        help="pack the full multi-column .lst label vector "
                             "(detection lists) instead of a scalar")
    args = parser.parse_args(argv)
    if args.list:
        make_list(args)
    else:
        im2rec(args)


if __name__ == "__main__":
    main()
