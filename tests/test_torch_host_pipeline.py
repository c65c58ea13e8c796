"""The port's copies of the JAX package's host modules, each against its
original on the same inputs: the prompt templates, the Processor, the image
transform (three resize strategies, PIL and the native C++ path), frame
sampling, video decoding (a raw AVI, where g++ and libav build the native
decoder), answer extraction, scoring (MCQ plain, duration and task-type
splits, TVG, YouCook2 DVC), CIDEr, the Python METEOR and the benchmark
loaders on an annotation tree the test writes. The port never imports the
originals; only this test imports both. Nothing here compiles JAX."""

import json
import os

import numpy as np
import pytest
from torch_parity import rng

from timeviper_tpu.data import conversation as j_conv
from timeviper_tpu.data import datasets as j_datasets
from timeviper_tpu.data import loader as j_loader
from timeviper_tpu.data import image_processing as j_img
from timeviper_tpu.data import native as j_native
from timeviper_tpu.data import native_video as j_native_video
from timeviper_tpu.data import processor as j_proc
from timeviper_tpu.data import templates as j_templates
from timeviper_tpu.data import video as j_video
from timeviper_tpu.eval import answers as j_answers
from timeviper_tpu.eval import cider as j_cider
from timeviper_tpu.eval import loaders as j_loaders
from timeviper_tpu.eval import meteor_py as j_meteor
from timeviper_tpu.eval import scoring as j_scoring
from timeviper_tpu.utils import overwatch as j_overwatch
from timeviper_tpu_torch.data import conversation as t_conv
from timeviper_tpu_torch.data import datasets as t_datasets
from timeviper_tpu_torch.data import loader as t_loader
from timeviper_tpu_torch.data import image_processing as t_img
from timeviper_tpu_torch.data import native as t_native
from timeviper_tpu_torch.data import native_video as t_native_video
from timeviper_tpu_torch.data import processor as t_proc
from timeviper_tpu_torch.data import templates as t_templates
from timeviper_tpu_torch.data import video as t_video
from timeviper_tpu_torch.eval import answers as t_answers
from timeviper_tpu_torch.eval import cider as t_cider
from timeviper_tpu_torch.eval import loaders as t_loaders
from timeviper_tpu_torch.eval import meteor_py as t_meteor
from timeviper_tpu_torch.eval import scoring as t_scoring
from timeviper_tpu_torch.utils import overwatch as t_overwatch


def _public(mod):
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("_") and isinstance(v, (str, list, tuple, dict))}


def test_templates_byte_for_byte():
    assert _public(t_templates) == _public(j_templates)
    assert sorted(t_conv.CONV_TEMPLATES) == sorted(j_conv.CONV_TEMPLATES)
    turns = [("user", "<image>\nwhat happens?"), ("assistant", "a man runs."),
             ("user", "and then?"), ("assistant", None)]
    for name in j_conv.CONV_TEMPLATES:
        t, j = t_conv.CONV_TEMPLATES[name], j_conv.CONV_TEMPLATES[name]
        for system in (True, False):
            assert t.render(turns, include_system=system) == j.render(turns, include_system=system)
            assert (t.prompt_for_generation("q?", include_system=system)
                    == j.prompt_for_generation("q?", include_system=system))


def _tokenizer(**special):
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    words = "<pad> <unk> <SPECIAL_10> <SPECIAL_11> <SPECIAL_12> System User Assistant what is it ."
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words.split())},
                                     unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    return PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>", unk_token="<unk>",
                                   eos_token="<SPECIAL_12>", **special)


def test_processor_on_one_tokenizer():
    frames = list(rng(0).integers(0, 255, (3, 40, 30, 3), dtype=np.uint8))
    prompt = t_conv.CONV_NANO.prompt_for_generation("<image>" * 3 + "\nwhat is it .")
    got = t_proc.Processor.build(_tokenizer(), t_img.transform_for_family("siglip", 28), "nano")
    want = j_proc.Processor.build(_tokenizer(), j_img.transform_for_family("siglip", 28), "nano")
    assert (got.image_token_id, got.terminator_ids) == (want.image_token_id, want.terminator_ids)
    g, w = got(prompt, videos=[frames]), want(prompt, videos=[frames])
    assert g["input_ids"].dtype == w["input_ids"].dtype
    assert np.array_equal(g["input_ids"], w["input_ids"])
    assert np.array_equal(g["pixels"], w["pixels"])
    assert got.decode(g["input_ids"].tolist()) == want.decode(w["input_ids"].tolist())
    with pytest.raises(ValueError):
        got(prompt, videos=[frames[:2]])


def test_processor_on_a_tokenizer_without_the_replace_keyword():
    """transformers 5 names the keyword `replace_extra_special_tokens`, not
    `replace_additional_special_tokens`, and replaces the tokenizer's own
    extra special tokens without it: the port passes whichever keyword the
    tokenizer takes, so those tokens stay special beside `<image>`, as the
    JAX processor keeps them, and decoding skips them alike. A tokenizer that
    takes neither keyword is refused."""
    class Transformers5:
        def __init__(self, tok):
            self._tok = tok

        def add_special_tokens(self, tokens, replace_extra_special_tokens=True):
            return self._tok.add_special_tokens(
                tokens, replace_additional_special_tokens=replace_extra_special_tokens)

        def __getattr__(self, name):
            return getattr(self._tok, name)

    class NoKeyword(Transformers5):
        def add_special_tokens(self, tokens):
            return self._tok.add_special_tokens(tokens)

    def extra():  # a fresh list: the tokenizer appends to the one it is given
        return dict(additional_special_tokens=["<SPECIAL_10>", "<SPECIAL_11>"])

    tok = Transformers5(_tokenizer(**extra()))
    got = t_proc.Processor.build(tok, t_img.transform_for_family("siglip", 28), "nano")
    want = j_proc.Processor.build(_tokenizer(**extra()), j_img.transform_for_family("siglip", 28),
                                  "nano")
    assert (got.image_token_id, got.terminator_ids) == (want.image_token_id, want.terminator_ids)
    assert tok.additional_special_tokens == want.tokenizer.additional_special_tokens == [
        "<SPECIAL_10>", "<SPECIAL_11>", "<image>"]
    text = "<SPECIAL_10> <image> what <SPECIAL_11> is it"
    assert got.tokenize(text) == want.tokenize(text)
    assert got.decode(got.tokenize(text)) == want.decode(want.tokenize(text)) == "what is it"
    with pytest.raises(TypeError, match="replace_extra_special_tokens"):
        t_proc.attach_special_tokens(NoKeyword(_tokenizer(**extra())), "nano")


@pytest.mark.parametrize("strategy", ["resize-naive", "resize-crop", "letterbox"])
@pytest.mark.parametrize("family", ["siglip", "dinov2"])
def test_image_transform_pil(strategy, family):
    frame = rng(1).integers(0, 255, (37, 52, 3), dtype=np.uint8)
    got = t_img.transform_for_family(family, 28, strategy)(frame)
    want = j_img.transform_for_family(family, 28, strategy)(frame)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_image_transform_batch_and_native():
    """`batch` makes JAX's native-or-PIL choice; the native libraries, each
    built from its package's copy of preprocess.cpp, give the same floats."""
    frames = rng(2).integers(0, 255, (5, 45, 60, 3), dtype=np.uint8)
    for strategy in ("resize-naive", "letterbox"):
        got = t_img.transform_for_family("siglip", 28, strategy).batch(list(frames))
        want = j_img.transform_for_family("siglip", 28, strategy).batch(list(frames))
        assert np.array_equal(got, want), strategy
    if not (t_native.native_available() and j_native.native_available()):
        pytest.skip("native preprocess library unavailable (no g++)")
    mean, std = t_img.IMAGENET_MEAN, t_img.IMAGENET_STD
    got = t_native.preprocess_frames_native(frames, 28, mean, std, n_threads=2)
    want = j_native.preprocess_frames_native(frames, 28, mean, std, n_threads=2)
    assert np.array_equal(got, want)


DURATIONS = (0.4, 3.0, 59.9, 600.0, 5400.0)
VIDEO_FPS = (1.0, 23.976, 30.0, 59.94)


@pytest.mark.parametrize("video_fps", VIDEO_FPS)
def test_frame_sampling(video_fps):
    for dur in DURATIONS:
        total = max(1, int(dur * video_fps))
        for n in (1, 4, 7, 32, 256):
            assert np.array_equal(t_video.uniform_indices(n, total),
                                  j_video.uniform_indices(n, total))
        for fps, lo, hi in ((1.0, 1, -1), (0.5, 32, 256), (2.0, 4, 768), (None, 8, 64)):
            assert np.array_equal(t_video.fps_indices(video_fps, total, fps, lo, hi),
                                  j_video.fps_indices(video_fps, total, fps, lo, hi))
        for kw in ({}, {"fps": 1.0}, {"fps": 0.5, "max_frames": 64}, {"nframes": 8}):
            try:
                want = j_video.smart_nframes(total, video_fps, **kw)
            except ValueError:
                with pytest.raises(ValueError):
                    t_video.smart_nframes(total, video_fps, **kw)
                continue
            assert t_video.smart_nframes(total, video_fps, **kw) == want
        for start, end in ((0.0, None), (0.2 * dur, 0.7 * dur), (dur, dur + 5.0)):
            try:
                wi, wf = j_video.timestamp_indices(total, video_fps, start, end)
            except ValueError:
                with pytest.raises(ValueError):
                    t_video.timestamp_indices(total, video_fps, start, end)
                continue
            gi, gf = t_video.timestamp_indices(total, video_fps, start, end)
            assert np.array_equal(gi, wi) and gf == wf


def test_load_video_on_a_raw_avi(tmp_path):
    if not (t_native_video.native_video_available() and j_native_video.native_video_available()):
        pytest.skip("native video decoder unavailable (g++ or libav missing)")
    from tests.test_native_video import write_raw_avi

    frames = rng(3).integers(0, 255, (14, 24, 32, 3), dtype=np.uint8)
    path = str(tmp_path / "clip.avi")
    write_raw_avi(path, frames, fps=7)
    for kw in ({"sampling": "fps", "fps": 2.0, "min_frames": 4, "max_frames": 8},
               {"sampling": "uniform", "num_frames": 5}):
        gf, gts, gmeta = t_video.load_video(path, **kw)
        wf, wts, wmeta = j_video.load_video(path, **kw)
        assert np.array_equal(gf, wf) and np.array_equal(gts, wts)
        assert (gmeta.total_frames, gmeta.fps, gmeta.duration) == (
            wmeta.total_frames, wmeta.fps, wmeta.duration)


ANSWERS = [
    ("mcq", "(B) the man"), ("mcq", "Best Option: (C"), ("mcq", "none of these"),
    ("mcq", "A. blue sky"), ("tg", "The event happens from 12.5 to 30 seconds."),
    ("tg", "no time here"), ("tg", "3 - 9.5 seconds"),
    ("caption", "0 - 10 seconds, chop the onions. 12 - 30 seconds, fry them in oil."),
    ("caption", "From 5.0s to 9s a man walks; then 10 to 20 seconds he sits."),
    ("caption", "nothing timed"),
]


@pytest.mark.parametrize("datatype,text", ANSWERS)
def test_answers(datatype, text):
    assert t_answers.extract_answer(text, datatype) == j_answers.extract_answer(text, datatype)


def test_dataset_types():
    for name in j_loaders.BENCHMARKS:
        assert t_answers.get_dataset_type(name) == j_answers.get_dataset_type(name)


def _write_preds(path, dataset: str):
    r = rng(4)
    recs = []
    for i in range(3 if dataset == "youcook2" else 12):
        task = ["count", "order", ["plot", "ego"] if dataset == "mlvu" else "plot"][i % 3]
        rec = {"qid": f"{dataset}|{i}", "duration": ["short", "medium", "long"][i % 3],
               "task_type": task}
        if dataset == "charades":
            a = float(r.uniform(0, 20))
            rec.update(pred=[a, a + float(r.uniform(1, 10))] if i % 5 else [None, None],
                       target=[float(r.uniform(0, 20)), float(r.uniform(20, 40))])
        elif dataset == "youcook2":
            n = 1 + i % 3
            rec.update(pred={"timestamps": [[10.0 * k, 10.0 * k + 8] for k in range(n)],
                             "captions": ["chop the onion", "fry it", "serve hot"][:n]},
                       target=[{"segment": [12 * k, 12 * k + 9], "sentence": s, "id": k}
                               for k, s in enumerate(["cut the onions", "fry them"])])
        else:
            rec.update(pred=None if i % 4 == 0 else int(r.integers(0, 4)),
                       target=int(r.integers(0, 4)), output_text="B. the man")
        recs.append(rec)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "0_of_1.jsonl"), "w") as f:
        f.writelines(json.dumps(x) + "\n" for x in recs)


@pytest.mark.parametrize("dataset", ["mvbench", "videomme", "mlvu", "charades", "youcook2"])
def test_scoring(dataset, tmp_path):
    """MCQ plain, the duration and task-type splits, TVG IoU and YouCook2's
    SODA_c / paragraph CIDEr (scoring imports dvc lazily)."""
    _write_preds(str(tmp_path), dataset)
    got = t_scoring.calc_score(t_scoring.load_scored_data(str(tmp_path), dataset), dataset)
    want = j_scoring.calc_score(j_scoring.load_scored_data(str(tmp_path), dataset), dataset)
    assert got == want and got
    data = list(range(11))
    assert all(t_scoring.zigzag_split(data, c, 3) == j_scoring.zigzag_split(data, c, 3)
               for c in range(3))


CAPTIONS = (["a man is slicing a tomato on a board", "the cat sleeps."],
            [["a man slices a tomato", "someone cuts tomatoes on a board"],
             ["a cat is sleeping on the sofa"]])


def test_cider_and_meteor():
    hyps, refs = CAPTIONS
    assert t_cider.cider_score(hyps, refs) == j_cider.cider_score(hyps, refs)
    for h, rs in zip(hyps, refs):
        assert t_meteor.sentence_score(h, rs) == j_meteor.sentence_score(h, rs)
    assert t_meteor.normalize(hyps[1]) == j_meteor.normalize(hyps[1])


def _wjson(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def _touch(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    open(path, "wb").close()


@pytest.fixture()
def tree(tmp_path, monkeypatch):
    """One annotation tree of five benchmarks; both loaders resolve ./dataset
    in it."""
    monkeypatch.chdir(tmp_path)
    _wjson("dataset/activitynet/annotations/sentence_temporal_grounding/val.json",
           {"v_a": {"duration": 120.5, "timestamps": [[0, 10], [20, 42.5]],
                    "sentences": ["A man runs. ", "He stops."]}})
    _touch("dataset/activitynet/videos/v_a.mkv")
    _wjson("dataset/mvbench/json/action_count.json",
           [{"video": "p1.mp4", "question": "how many?", "candidates": ["3", "4"],
             "answer": "4"}])
    _wjson("dataset/mvbench/json/action_localization.json",
           [{"video": "s1.mp4", "question": "when?", "candidates": ["a", "b"], "answer": "a",
             "start": 1.5, "end": 7.0}])
    _wjson("dataset/cgbench/cgbench.json",
           [{"video_uid": "u1", "question": "what?", "choices": ["x", "y", "z"],
             "right_answer": "C", "duration": 1800.0, "sub_category": "event", "qid": "31"}])
    _wjson("dataset/youcook2/annotations/youcookii_annotations_trainval.json",
           {"database": {"y1": {"subset": "validation", "recipe_type": "101",
                                "duration": 241.6,
                                "annotations": [{"segment": [0, 30], "sentence": "chop",
                                                 "id": 0}]}}})
    _touch("dataset/youcook2/raw_videos/validation/101/y1.webm")
    os.makedirs("dataset/auroracap", exist_ok=True)
    with open("dataset/auroracap/VDC_1k.jsonl", "w") as f:
        f.write(json.dumps({"video_name": "c.mp4", "video_id": "c1", "background_caption": "bg",
                            "camera_caption": "cam", "detailed_caption": "det",
                            "main_object_caption": "obj", "short_caption": "sh"}) + "\n")
    return tmp_path


@pytest.mark.parametrize("name,split", [("activitynet", "val"), ("mvbench", "default"),
                                        ("cgbench", "default"), ("youcook2", "val"),
                                        ("auroracap", "short")])
def test_loaders(name, split, tree):
    got = t_loaders.load_benchmark(name, split=split)
    want = j_loaders.load_benchmark(name, split=split)
    key = (lambda r: r["qid"])
    assert sorted(got, key=key) == sorted(want, key=key) and got


# -- training data: datasets, the threaded loader, overwatch ----------------


@pytest.mark.parametrize("has_system", [True, False])
def test_label_masking(has_system):
    ids = rng(7).integers(0, 9, 40)
    for sep in (3, 8):
        np.testing.assert_array_equal(
            t_datasets.mask_labels_by_separator(ids, sep, has_system),
            j_datasets.mask_labels_by_separator(ids, sep, has_system))


def _video_loader(item, cfg):
    if item.get("video") == "bad.mp4":
        raise OSError("corrupt")
    n = cfg.num_frames
    return rng(len(item["video"])).integers(0, 255, (n, 30, 40, 3), dtype=np.uint8), 12.3, n


def _data_yaml(tmp_path):
    conv = [{"from": "human", "value": "<image> what is it ."}, {"from": "gpt", "value": "it ."}]
    specs = {
        "caption": ("caption", [{"video": f"c{i}.mp4", "caption": "it is ."} for i in range(3)]),
        "tvg": ("tvg", [{"video": "t.mp4", "conversations": conv}]),
        "dvc": ("dvc", [{"video": "d.mp4", "conversations": conv}]),
        "packed": ("conversation_packed",
                   [{"video": f"p{i}.mp4", "conversations": conv} for i in range(5)]),
        "retry": ("conversation", [{"video": "bad.mp4", "conversations": conv},
                                   {"video": "ok.mp4", "conversations": conv}]),
    }
    lines = ["datasets:"]
    for name, (fmt, items) in specs.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(items))
        lines += [f"  - format: {fmt}", f"    json_path: {tmp_path / name}.json",
                  "    num_frames: 2", "    pack_size: 2", "    split: [0, -1]"]
    (tmp_path / "data.yaml").write_text("\n".join(lines) + "\n")
    return str(tmp_path / "data.yaml")


def test_datasets_from_one_yaml(tmp_path):
    """Every format of load_data_from_config (caption, TVG, DVC, a packed
    conversation, a corrupt sample's random substitute) and ConcatDataset
    give the JAX package's items on one tokenizer, the same draws of
    Python's `random` on both sides."""
    import random
    import warnings

    path = _data_yaml(tmp_path)
    procs = [mod.Processor.build(_tokenizer(), img.transform_for_family("siglip", 28), "nano")
             for mod, img in ((t_proc, t_img), (j_proc, j_img))]
    sides = [ds_mod.ConcatDataset(ds_mod.load_data_from_config(path, proc,
                                                               video_loader=_video_loader))
             for ds_mod, proc in zip((t_datasets, j_datasets), procs)]
    assert len(sides[0]) == len(sides[1]) == 3 + 1 + 1 + 3 + 2
    for i in range(len(sides[0])):
        items = []
        for side in sides:
            random.seed(i)
            with warnings.catch_warnings(record=True):
                warnings.simplefilter("always")
                items.append(side[i])
        got, want = items
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(got[k], v) and got[k].dtype == v.dtype, (i, k)
            else:
                assert got[k] == v, (i, k)


@pytest.mark.parametrize("n,bs,pc,drop_last,shuffle", [
    (10, 3, 1, True, True), (10, 3, 2, False, True), (7, 2, 3, True, False),
    (5, 4, 2, False, False), (2, 4, 1, True, True)])
def test_data_loader_order_matches_jax(n, bs, pc, drop_last, shuffle):
    import warnings

    items = [{"input_ids": np.asarray([5, 500, 6 + i] + [7] * (i % 3)),
              "labels": np.asarray([-100, -100, 6 + i] + [7] * (i % 3)),
              "pixels": np.full((1, 4, 4, 3), i, np.float32)} for i in range(n)]
    for pi in range(pc):
        kw = dict(image_token_id=500, tokens_per_frame=2, shuffle=shuffle, seed=3,
                  num_workers=1, drop_last=drop_last, process_index=pi, process_count=pc)
        got_l, want_l = t_loader.DataLoader(items, bs, **kw), j_loader.DataLoader(items, bs, **kw)
        assert len(got_l) == len(want_l)
        for epoch in (0, 1):
            with warnings.catch_warnings(record=True):
                warnings.simplefilter("always")
                assert got_l._index_batches(epoch) == want_l._index_batches(epoch)
                got, want = list(got_l.epoch(epoch)), list(want_l.epoch(epoch))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert type(g.plan).__name__ == type(w.plan).__name__
                for k, v in w.batch.items():
                    assert np.array_equal(g.batch[k], v), k


def test_data_loader_raises_a_workers_error_and_stops_early():
    def bad(i):
        raise KeyError(i)

    class Bad:
        def __len__(self):
            return 4

        __getitem__ = staticmethod(bad)

    with pytest.raises(KeyError):
        list(t_loader.DataLoader(Bad(), 2, 500, 2, num_workers=2).epoch(0))
    items = [{"input_ids": np.asarray([5, 6]), "labels": np.asarray([5, 6])}] * 40
    it = t_loader.DataLoader(items, 2, 500, 2, num_workers=3, prefetch=1).epoch(0)
    next(it)
    it.close()  # the workers stop; nothing hangs


def test_data_loader_yields_in_index_order_whatever_the_workers_speeds():
    """Every rank of a mesh reads the same data and takes its rows, so the
    batches must come out in index order: here the first worker's batches
    (0 and 3 of 6) are the slow ones."""
    import time

    class Slow:
        def __len__(self):
            return 12

        def __getitem__(self, i):
            time.sleep(0.05 if (i // 2) % 3 == 0 else 0.0)
            return {"input_ids": np.asarray([5, 6 + i]), "labels": np.asarray([5, 6 + i])}

    loader = t_loader.DataLoader(Slow(), 2, 500, 2, shuffle=False, num_workers=3)
    got = [cb.batch["input_ids"][:, 1].tolist() for cb in loader.epoch(0)]
    assert got == [[6 + 2 * b, 7 + 2 * b] for b in range(6)]


def test_overwatch_and_tee(tmp_path, capsys):
    assert t_overwatch.Overwatch("t").rank == 0
    for mod in (t_overwatch, j_overwatch):
        path = tmp_path / f"{mod.__name__}.log"
        tee = mod.Tee(str(path), __import__("sys").stdout)
        tee.write("one line\n")
        tee.flush()
        tee.file.close()
        assert path.read_text() == "one line\n"
    out = capsys.readouterr().out
    assert out.count("one line") == 2
    ow = t_overwatch.initialize_overwatch("timeviper_test")
    assert ow._fmt("x") == j_overwatch.initialize_overwatch("timeviper_test_j")._fmt("x")
    with ow.ctx("title"):
        assert ow._fmt("y") == "\t+=> y"


def test_profile_ctx_and_nan_debug(tmp_path):
    """utils/profiling.py: a torch.profiler trace written where asked;
    nan_debug's anomaly mode names the op whose backward gave a NaN, and is
    off again after the block."""
    import torch

    from timeviper_tpu_torch.utils.profiling import nan_debug, profile_ctx

    with profile_ctx(str(tmp_path / "prof")):
        torch.ones(3).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    x = torch.zeros(1, requires_grad=True)
    with nan_debug(True), pytest.warns(UserWarning), pytest.raises(RuntimeError, match="nan"):
        (x / x).sum().backward()
    assert not torch.is_anomaly_enabled()
