"""Train point/line vocabularies from imagery (the ORBvoc/LSDvoc analog).

Usage:
  python scripts/train_vocab.py [--euroc DIR | --kitti DIR] \
      [--out vocab] [--words 4096] [--frames 200]

Without a dataset directory, descriptors are harvested from the
synthetic room sequence (the same scene bench.py runs). Produces
`<out>_pt.npz` and `<out>_ln.npz` TrainedVocabulary files; load them
into a tracker with:

  from pli_slam_tpu.worldmap.vocab import TrainedVocabulary
  tr = Tracker(cam, cfg, vocab_pt=TrainedVocabulary.load("vocab_pt.npz"),
                         vocab_ln=TrainedVocabulary.load("vocab_ln.npz"))

(reference: the shipped learned ORBvoc.txt/LSDvoc.txt trees loaded at
src/System.cc:84-86; training here is binary k-means over harvested
descriptors — worldmap/vocab.train_vocabulary.)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from pli_slam_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--euroc", help="EuRoC sequence dir (mav0 layout)")
    ap.add_argument("--kitti", help="KITTI odometry sequence dir")
    ap.add_argument("--out", default="vocab")
    ap.add_argument("--words", type=int, default=4096)
    ap.add_argument("--line-words", type=int, default=1024)
    ap.add_argument("--frames", type=int, default=200)
    args = ap.parse_args()

    from pli_slam_tpu.ops import lines as line_ops
    from pli_slam_tpu.ops import orb
    from pli_slam_tpu.ops.camera import Camera
    from pli_slam_tpu.utils.config import SlamConfig
    from pli_slam_tpu.worldmap import vocab as vocab_mod

    cfg = SlamConfig.euroc_stereo()
    extract = jax.jit(lambda im: orb.extract(im, cfg.orb))
    detect = jax.jit(lambda im: line_ops.detect(im, cfg.lines))

    def harvest(img):
        f = extract(img)
        l = detect(img)
        fv = np.asarray(f.valid)
        lv = np.asarray(l.valid)
        return np.asarray(f.desc)[fv], np.asarray(l.desc)[lv]

    pt_sets, ln_sets = [], []
    if args.euroc:
        from pli_slam_tpu.utils.euroc import EurocSequence

        for i, fr in enumerate(EurocSequence(args.euroc).frames(stop=args.frames)):
            p, l = harvest(jnp.asarray(fr["img_l"], jnp.float32))
            pt_sets.append(p)
            ln_sets.append(l)
    elif args.kitti:
        from pli_slam_tpu.utils.datasets import KittiSequence

        for i, fr in enumerate(KittiSequence(args.kitti).frames(stop=args.frames)):
            p, l = harvest(jnp.asarray(fr["img_l"], jnp.float32))
            pt_sets.append(p)
            ln_sets.append(l)
    else:
        from pli_slam_tpu.utils import synthetic

        cam = Camera.pinhole(fx=435.2, fy=435.2, cx=367.4, cy=252.2,
                             bf=0.11 * 435.2, width=752, height=480)
        # a wider-roaming trajectory than the bench for view diversity
        traj = synthetic.Trajectory(amp=(3.5, 2.5, 1.2), freq=(0.07, 0.09, 0.05),
                                    yaw_amp=2.5, yaw_freq=0.04)
        n = min(args.frames, 120)
        for i, fr in enumerate(synthetic.make_sequence(cam, n, fps=4.0, traj=traj)):
            p, l = harvest(fr["img_l"])
            pt_sets.append(p)
            ln_sets.append(l)
            if i % 20 == 0:
                print(f"harvested {i}/{n}", file=sys.stderr, flush=True)

    voc_pt = vocab_mod.train_vocabulary(pt_sets, n_words=args.words, iters=10)
    voc_pt.save(f"{args.out}_pt.npz")
    voc_ln = vocab_mod.train_vocabulary(ln_sets, n_words=args.line_words, iters=10)
    voc_ln.save(f"{args.out}_ln.npz")
    n_pt = sum(len(d) for d in pt_sets)
    n_ln = sum(len(d) for d in ln_sets)
    print(f"trained {args.out}_pt.npz ({args.words} words, {n_pt} descs) "
          f"and {args.out}_ln.npz ({args.line_words} words, {n_ln} descs)")


if __name__ == "__main__":
    main()
