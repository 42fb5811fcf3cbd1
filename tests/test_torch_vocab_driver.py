"""The port's vocabulary driver (`monocular_slam_tpu_torch/benchmarks/
train_vocab.py`) against the reference's functions composed as
`benchmarks/train_vocab.py` composes them (never its `main()`, which writes
`benchmarks/vocab_eval_<platform>.json`), on the CPU at a tiny size:

  - `augment` draws what the reference's `_augment` draws from the same
    `RandomState(7)`;
  - one scene's corpus (each frame's valid descriptors, then its
    augmentation's) is the reference's extraction of the same frames with
    the same draws, by `test_torch_slice.py::test_extract_rendered_frame`'s
    rule: equal valid counts, descriptor bits equal on >= 99.5% (the rest
    are round/arctan2 ties of the orientation). The frames are the port's
    renders (`render_sequence(quantize=False)`): the reference's own
    renderer gives floats within ~0.03 grey levels of them;
  - the vocabulary trained on that corpus equals the reference's
    `vocabulary.train` on it, and the revisit recall and margins of a tiny
    eval scene's features equal the reference's `bow_vector` and L1
    scoring composed as its driver composes them (recall exactly, margins
    to 1e-6);
  - the run writes `vocab_eval_tpu.json`'s keys.

The reference runs with x64 off, as outside the tests."""

import json
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from benchmarks import train_vocab as jdriver
from monocular_slam_tpu.ops import features as jfeat
from monocular_slam_tpu.retrieval import vocabulary as jvoc
from monocular_slam_tpu_torch.benchmarks import train_vocab
from monocular_slam_tpu_torch.retrieval import vocabulary as tvoc
from port_util import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
WH = (320, 240)
N_EVAL = 8  # 4 database and 4 query frames
SHAPE = (4, 3)  # 64 words: a tiny corpus fills few of 10^4


@pytest.fixture(scope="module")
def reference_extract():
    ext = jax.jit(partial(jfeat.extract, n_features=train_vocab.N_FEATURES))

    def extract(img):
        with jax.enable_x64(False):
            f = ext(jnp.asarray(img, jnp.float32))
        return np.asarray(f.desc_pm1), np.asarray(f.valid)

    return extract


def test_augment_is_the_reference():
    img = np.random.RandomState(0).uniform(0, 255, (24, 32)).astype(np.float32)
    a, b = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(3):
        np.testing.assert_array_equal(train_vocab.augment(img, a), jdriver._augment(img, b))


def test_scene_corpus_and_eval_like_reference(reference_extract):
    """The corpus, vocabulary and eval of one tiny scene each."""
    imgs = train_vocab.render(train_vocab.TRAIN_KEY0, 2, "cpu", WH,
                              ang_step=train_vocab.TRAIN_ANG_STEP)
    extract = train_vocab.extractor("cpu")
    got = train_vocab.scene_corpus(imgs, extract, 1, np.random.RandomState(7))
    rng = np.random.RandomState(7)
    want = []
    for im in imgs:
        for frame in (im, jdriver._augment(im, rng)):
            d, v = reference_extract(frame)
            want.append(d[v])
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape and len(g) > 100
        assert (g == w).mean() >= 0.995
    corpus = np.concatenate(got)

    voc = tvoc.train(corpus, *SHAPE, seed=0, device="cpu")
    jv = jvoc.train(corpus, *SHAPE, seed=0)
    for a, b in zip(voc.nodes, jv.nodes):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(voc.weights.numpy(), np.asarray(jv.weights), rtol=1e-6)

    ang = 2 * np.pi / 26
    db_imgs = train_vocab.render(train_vocab.EVAL_KEY0, N_EVAL, "cpu", WH, ang_step=ang)
    q_imgs = train_vocab.render(train_vocab.EVAL_KEY0, N_EVAL, "cpu", WH, ang_step=ang,
                                radius=train_vocab.QUERY_RADIUS)
    feats = train_vocab.eval_scene(db_imgs, q_imgs, extract, np.random.RandomState(3))
    res = train_vocab.evaluate(voc, [feats])

    # the reference's eval loop on the same features
    half = N_EVAL // 2
    fr = [(d.numpy(), v.numpy()) for d, v in feats]
    with jax.enable_x64(False):
        bows = [np.asarray(jvoc.bow_vector(jv, jnp.asarray(d), jnp.asarray(v))) for d, v in fr]
    db = np.stack(bows[:half])
    hits, margins = 0, []
    for q in range(half, N_EVAL):
        scores = 1.0 - 0.5 * np.abs(db - bows[q][None]).sum(axis=1)
        best = int(scores.argmax())
        want_i = q - half
        hits += abs(best - want_i) <= 2 or abs(best - want_i) >= 24
        margins.append(float(scores[best]) - float(np.median(scores)))
    assert res["n_queries"] == half and res["words"] == 4**3
    assert res["top1_recall_shifted"] == hits / half
    np.testing.assert_allclose(res["median_margin"], np.median(margins), atol=1e-6)
    np.testing.assert_allclose(res["margin_p10"], np.percentile(margins, 10), atol=1e-6)


def test_run_writes_the_reference_keys():
    out = train_vocab.run(1, 1, 0, 1, device="cpu", n_eval=4, wh=(160, 120))
    want = json.loads((ROOT / "benchmarks" / "vocab_eval_tpu.json").read_text())
    assert list(out) == list(want)
    assert list(out["results"]) == ["10k"]
    assert list(out["results"]["10k"]) == list(want["results"]["10k"])
    assert out["results"]["10k"]["words"] == 10**4
    assert 0.0 <= out["results"]["10k"]["top1_recall_shifted"] <= 1.0
