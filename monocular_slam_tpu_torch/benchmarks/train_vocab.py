"""Train and evaluate the bundled vocabulary on the card (the counterpart of
`benchmarks/train_vocab.py`, whose `vocab_eval_*.json` keys it writes).

DBoW2's shipped ORB vocabulary is k=10, L=5 (1e5 words). This trains the
1e4 (k=10, L=4) shape, and with `--big` the 1e5 one, with
`retrieval/vocabulary.train` on a corpus of rendered scenes (the
reference's: scenes `PRNGKey(100 + s)`, 0.12 rad a frame, each frame also
photometrically augmented `--augs` times from `RandomState(7)`), its ORB
descriptors extracted on the card (K1), and evaluates place recognition on
DISJOINT scenes under DOMAIN SHIFT: per eval scene `PRNGKey(900 + s)`, 52
frames (two revolutions of 26); the database is the clean first
revolution, the queries the second revolution rendered at orbit radius
1.72 and photometrically shifted. A query is right when its best L1 score
is the same scene within 2 frames of the view it revisits; the margin is
the best score minus the median.

The frames are the renderer's floats, as the reference's
`render_sequence` returns them (`render_sequence(quantize=False)`).
`--save` writes the winning tree to the port's bundled vocabulary
(`retrieval/default_vocab.npz`), never to the JAX package.

    python -m monocular_slam_tpu_torch.benchmarks.train_vocab [--train-scenes 12] [--eval-scenes 4] [--big] [--save] [--out F] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from monocular_slam_tpu_torch.benchmarks import device_label

WH = (640, 480)
N_FEATURES = 1000
TRAIN_KEY0, EVAL_KEY0 = 100, 900
TRAIN_ANG_STEP = 0.12
N_EVAL = 52  # two revolutions at 26 frames a revolution
QUERY_RADIUS = 1.72
AUG_SEED = 7
SHAPES = {"10k": (10, 4)}
BIG_SHAPES = {"100k (DBoW2 default)": (10, 5)}
PROTOCOL = (
    "DB = first revolution of each DISJOINT eval scene (clean); query = second revolution "
    "rendered at a perturbed orbit radius and photometrically shifted (gamma 0.55-1.7, "
    "gain/bias, sensor noise). top-1 correct iff same scene within 2 frames of the revisited "
    "view. margin = best minus median score (what the detector's consistency gate sees).")


def augment(img: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """Photometric domain shift: gamma, gain and bias, sensor noise (the
    reference's `_augment`, the same draws from `rng`)."""
    gamma = rng.uniform(0.55, 1.7)
    gain = rng.uniform(0.6, 1.3)
    bias = rng.uniform(-20, 25)
    out = 255.0 * (np.clip(img, 0, 255) / 255.0) ** gamma
    out = np.clip(out * gain + bias + rng.normal(0, 4.0, img.shape), 0, 255)
    return out.astype(np.float32)


def extractor(device, n_features: int = N_FEATURES):
    """img (H, W) numpy or tensor -> ORB `Features` on `device` (K1 on the
    card), at the extraction's defaults."""
    from monocular_slam_tpu_torch.ops import features as features_mod

    dev = torch.device(device)

    def extract(img):
        with torch.inference_mode():
            return features_mod.extract(torch.as_tensor(img, dtype=torch.float32, device=dev),
                                        n_features=n_features)

    return extract


def frame_descs(extract, img) -> np.ndarray:
    """The frame's valid descriptors, (n, 256) int8 +-1."""
    f = extract(img)
    return f.desc_pm1[f.valid].cpu().numpy()


def render(key: int, n_frames: int, device, wh=WH, **kw) -> np.ndarray:
    """The renderer's float frames of scene `PRNGKey(key)`, as numpy."""
    from monocular_slam_tpu_torch.datasets import render as render_mod

    imgs, _, _ = render_mod.render_sequence(key, n_frames=n_frames, wh=wh, device=device,
                                            quantize=False, **kw)
    return imgs.cpu().numpy()


def scene_corpus(imgs: np.ndarray, extract, augs: int, rng) -> list:
    """Each frame's descriptors, then those of its `augs` augmentations,
    in the reference's order."""
    out = []
    for im in imgs:
        out.append(frame_descs(extract, im))
        for _ in range(augs):
            out.append(frame_descs(extract, augment(im, rng)))
    return out


def eval_scene(db_imgs: np.ndarray, query_imgs: np.ndarray, extract, rng) -> list:
    """(desc_pm1, valid) of the clean first half of `db_imgs` and of the
    augmented second half of `query_imgs`."""
    half = len(db_imgs) // 2
    fr = []
    for i in range(half):
        f = extract(db_imgs[i])
        fr.append((f.desc_pm1, f.valid))
    for i in range(half, len(query_imgs)):
        f = extract(augment(query_imgs[i], rng))
        fr.append((f.desc_pm1, f.valid))
    return fr


def evaluate(voc, eval_feats: list) -> dict:
    """Top-1 recall and margins of the revisit queries (L1 scores of BoW
    vectors against every scene's database frames)."""
    from monocular_slam_tpu_torch.retrieval import vocabulary

    db, db_ids = [], []
    with torch.inference_mode():
        bows = [[vocabulary.bow_vector(voc, d, v).cpu().numpy() for d, v in fr]
                for fr in eval_feats]
    for s, fr in enumerate(bows):
        half = len(fr) // 2
        for i in range(half):
            db.append(fr[i])
            db_ids.append((s, i))
    db = np.stack(db)
    hits = total = 0
    margins = []
    for s, fr in enumerate(bows):
        half = len(fr) // 2
        for q in range(half, len(fr)):
            scores = 1.0 - 0.5 * np.abs(db - fr[q][None]).sum(axis=1)
            best = int(scores.argmax())
            bs, bi = db_ids[best]
            want = q - half
            hits += (bs == s) and (abs(bi - want) <= 2 or abs(bi - want) >= 24)
            total += 1
            margins.append(float(scores[best]) - float(np.median(scores)))
    m = np.asarray(margins)
    return {"words": int(voc.n_words), "top1_recall_shifted": hits / total,
            "margin_p10": float(np.percentile(m, 10)), "median_margin": float(np.median(m)),
            "n_queries": total}


def run(train_scenes: int = 12, frames_per_scene: int = 24, augs: int = 2, eval_scenes: int = 4,
        big: bool = False, save: bool = False, save_shape: str | None = None, device="cuda",
        n_eval: int = N_EVAL, wh=WH, details: dict | None = None) -> dict:
    """The reference driver's run under its keys. `details`, when given,
    receives the corpus size, the vocabularies and the seconds of each
    part."""
    from monocular_slam_tpu_torch.retrieval import vocabulary
    from monocular_slam_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    label = device_label(dev)
    print("device:", label, file=sys.stderr)
    det = details if details is not None else {}
    extract = extractor(dev)
    rng = np.random.RandomState(AUG_SEED)

    t0 = time.perf_counter()
    train = []
    for s in range(train_scenes):
        d = scene_corpus(render(TRAIN_KEY0 + s, frames_per_scene, dev, wh,
                                ang_step=TRAIN_ANG_STEP), extract, augs, rng)
        train += d
        print(f"  scene {s}: {sum(len(x) for x in d)} descriptors", file=sys.stderr)
    corpus = np.concatenate(train)
    det["corpus_s"] = time.perf_counter() - t0
    print(f"corpus: {len(corpus)} descriptors ({det['corpus_s']:.0f}s)", file=sys.stderr)

    shapes = dict(SHAPES, **(BIG_SHAPES if big else {}))
    vocs = {}
    for name, (k, L) in shapes.items():
        t0 = time.perf_counter()
        vocs[name] = vocabulary.train(corpus, k=k, L=L, seed=0, device=dev)
        det[f"train_s {name}"] = time.perf_counter() - t0
        print(f"trained {name}: {vocs[name].n_words} words in {det[f'train_s {name}']:.0f}s",
              file=sys.stderr)

    t0 = time.perf_counter()
    ang = 2 * np.pi / 26
    eval_feats = [eval_scene(render(EVAL_KEY0 + s, n_eval, dev, wh, ang_step=ang),
                             render(EVAL_KEY0 + s, n_eval, dev, wh, ang_step=ang,
                                    radius=QUERY_RADIUS), extract, rng)
                  for s in range(eval_scenes)]
    results = {name: evaluate(voc, eval_feats) for name, voc in vocs.items()}
    det["eval_s"] = time.perf_counter() - t0
    for name, r in results.items():
        print(name, r, file=sys.stderr)
    det |= {"vocabularies": vocs, "train_descriptors": len(corpus)}

    if save:
        pick = save_shape or max(results, key=lambda n: (results[n]["top1_recall_shifted"],
                                                         results[n]["median_margin"]))
        vocabulary.save(vocabulary.DEFAULT_PATH, vocs[pick])
        print(f"saved bundle ({pick}):", vocabulary.DEFAULT_PATH, file=sys.stderr)
    return {
        "device": label,
        "train_descriptors": int(len(corpus)),
        "train_scenes": train_scenes,
        "train_augs_per_frame": augs,
        "eval_scenes": eval_scenes,
        "protocol": PROTOCOL,
        "results": results,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-scenes", type=int, default=12)
    ap.add_argument("--frames-per-scene", type=int, default=24)
    ap.add_argument("--augs", type=int, default=2,
                    help="photometric augmentations per training frame")
    ap.add_argument("--eval-scenes", type=int, default=4)
    ap.add_argument("--big", action="store_true",
                    help="also train the 1e5-word (k=10, L=5) DBoW2 default shape")
    ap.add_argument("--save", action="store_true",
                    help="write the winning tree to the port's bundled vocabulary")
    ap.add_argument("--save-shape", default=None,
                    help="which result to bundle (default: best shifted recall, tie -> margin)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (--device cpu)")
    ap.add_argument("--out", default=None, help="write the JSON here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.train_scenes, args.frames_per_scene, args.augs, args.eval_scenes, args.big,
              args.save, args.save_shape, "cpu" if args.cpu else args.device)
    s = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(json.dumps(out, indent=1) + "\n")
    print(s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
