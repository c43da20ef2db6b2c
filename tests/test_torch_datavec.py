"""The port's DataVec bridge (``datavec/``: record readers and the iterators
that batch their records) and the dataset fetchers on the contracts of
``tests/test_datavec.py``, each held bitwise against the JAX package on
the same files: the records equal, the batches' arrays and masks equal."""
import numpy as np
import pytest

from deeplearning4j_tpu import datavec as jdv
from deeplearning4j_tpu.datasets import fetchers as jfetchers
from deeplearning4j_tpu_torch.datasets import fetchers
from deeplearning4j_tpu_torch.datavec import (
    CollectionRecordReader, CSVRecordReader, CSVSequenceRecordReader,
    ImageRecordReader, LineRecordReader, RecordReaderDataSetIterator,
    RecordReaderMultiDataSetIterator, SequenceRecordReaderDataSetIterator)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


def _same_batches(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        for f in ("features", "labels", "features_mask", "labels_mask"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                _same(x, y)


def test_csv_record_reader_numeric_fast_path(tmp_path):
    p = tmp_path / "d.csv"
    p.write_text("1,2,3\n4,5,6\n7,8,9\n10,11,12\n")
    recs = list(CSVRecordReader(p))
    assert recs == [[1, 2, 3], [4, 5, 6], [7, 8, 9], [10, 11, 12]]
    assert recs == list(jdv.CSVRecordReader(p))


def test_csv_record_reader_mixed_fields(tmp_path):
    p = tmp_path / "d.csv"
    p.write_text("a,1,2\nb,3,4\n")
    recs = list(CSVRecordReader(p))
    assert recs == [["a", 1.0, 2.0], ["b", 3.0, 4.0]]
    assert recs == list(jdv.CSVRecordReader(p))


def test_record_reader_dataset_iterator_classification(tmp_path):
    p = tmp_path / "iris-like.csv"
    rows = ["%f,%f,%d" % (i * 0.1, i * 0.2, i % 3) for i in range(10)]
    p.write_text("\n".join(rows) + "\n")
    it = RecordReaderDataSetIterator(CSVRecordReader(p), batch=4,
                                     label_index=2, num_classes=3)
    batches = list(it)
    assert [b.num_examples() for b in batches] == [4, 4, 2]
    b0 = batches[0]
    assert b0.features.shape == (4, 2) and b0.labels.shape == (4, 3)
    np.testing.assert_array_equal(np.argmax(b0.labels, 1), [0, 1, 2, 0])
    _same_batches(batches, jdv.RecordReaderDataSetIterator(
        jdv.CSVRecordReader(p), batch=4, label_index=2, num_classes=3))


def test_record_reader_dataset_iterator_regression():
    recs = [[1.0, 2.0, 3.0, 4.0]] * 6
    it = RecordReaderDataSetIterator(CollectionRecordReader(recs), batch=3,
                                     label_index=2, label_index_to=3,
                                     regression=True)
    b = next(iter(it))
    assert b.features.shape == (3, 2) and b.labels.shape == (3, 2)
    np.testing.assert_allclose(b.labels[0], [3.0, 4.0])
    _same_batches(it, jdv.RecordReaderDataSetIterator(
        jdv.CollectionRecordReader(recs), batch=3, label_index=2,
        label_index_to=3, regression=True))
    # every column a feature (no label), and the last column by index -1
    _same_batches(
        RecordReaderDataSetIterator(CollectionRecordReader(recs), batch=4),
        jdv.RecordReaderDataSetIterator(jdv.CollectionRecordReader(recs),
                                        batch=4))
    _same_batches(
        RecordReaderDataSetIterator(CollectionRecordReader(recs), batch=4,
                                    label_index=-1, num_classes=5),
        jdv.RecordReaderDataSetIterator(jdv.CollectionRecordReader(recs),
                                        batch=4, label_index=-1,
                                        num_classes=5))


def test_sequence_record_reader_iterator(tmp_path):
    fdir, ldir = tmp_path / "f", tmp_path / "l"
    fdir.mkdir(), ldir.mkdir()
    lengths = [3, 5, 2]
    for i, L in enumerate(lengths):
        (fdir / f"{i}.csv").write_text(
            "\n".join(f"{t},{t * 2}" for t in range(L)) + "\n")
        (ldir / f"{i}.csv").write_text(
            "\n".join(str(t % 2) for t in range(L)) + "\n")
    it = SequenceRecordReaderDataSetIterator(
        CSVSequenceRecordReader(fdir), batch=3,
        labels=CSVSequenceRecordReader(ldir), num_classes=2)
    ds = next(iter(it))
    assert ds.features.shape == (3, 5, 2)
    assert ds.labels.shape == (3, 5, 2)
    np.testing.assert_array_equal(ds.features_mask.sum(axis=1), lengths)
    assert ds.features[2, 2:].sum() == 0  # padded steps are zero
    _same_batches(it, jdv.SequenceRecordReaderDataSetIterator(
        jdv.CSVSequenceRecordReader(fdir), batch=3,
        labels=jdv.CSVSequenceRecordReader(ldir), num_classes=2))
    # one reader whose rows carry the label, regression on it
    _same_batches(
        SequenceRecordReaderDataSetIterator(CSVSequenceRecordReader(fdir),
                                            batch=2, label_index=1),
        jdv.SequenceRecordReaderDataSetIterator(
            jdv.CSVSequenceRecordReader(fdir), batch=2, label_index=1))


def test_multi_dataset_iterator():
    recs = [[i, i + 1, i % 2] for i in range(8)]
    it = (RecordReaderMultiDataSetIterator(batch=4)
          .add_reader("r", CollectionRecordReader(recs))
          .add_input("r", 0, 1)
          .add_output_one_hot("r", 2, 2))
    ins, outs = next(iter(it))
    assert ins[0].shape == (4, 2) and outs[0].shape == (4, 2)
    np.testing.assert_array_equal(np.argmax(outs[0], 1), [0, 1, 0, 1])
    jit = (jdv.RecordReaderMultiDataSetIterator(batch=4)
           .add_reader("r", jdv.CollectionRecordReader(recs))
           .add_input("r", 0, 1).add_output_one_hot("r", 2, 2))
    for (a_in, a_out), (b_in, b_out) in zip(it, jit):
        for x, y in zip(a_in + a_out, b_in + b_out):
            _same(x, y)


def test_image_record_reader(tmp_path):
    from PIL import Image
    for person, color in [("alice", 200), ("bob", 50)]:
        d = tmp_path / person
        d.mkdir()
        for i in range(2):
            Image.fromarray(
                np.full((10, 8, 3), color, np.uint8)).save(d / f"{i}.png")
    rr = ImageRecordReader(tmp_path, height=4, width=4, channels=1)
    assert rr.labels == ["alice", "bob"] and rr.num_labels() == 2
    recs = list(rr)
    assert len(recs) == 4 and len(recs[0]) == 17  # 4*4 pixels + label
    assert recs[0][-1] == 0.0 and recs[-1][-1] == 1.0
    assert recs == list(jdv.ImageRecordReader(tmp_path, height=4, width=4,
                                              channels=1))
    rgb = list(ImageRecordReader(tmp_path, height=3, width=2))
    assert rgb == list(jdv.ImageRecordReader(tmp_path, height=3, width=2))


def test_cifar_iterator_shapes():
    it = fetchers.CifarDataSetIterator(batch=8, num_examples=32)
    ds = next(iter(it))
    assert ds.features.shape == (8, 32, 32, 3)
    assert ds.labels.shape == (8, 10)
    assert 0.0 <= ds.features.min() and ds.features.max() <= 1.0


def test_lfw_iterator_shapes():
    it = fetchers.LFWDataSetIterator(batch=10, num_examples=40, num_labels=5,
                                     image_size=16)
    ds = next(iter(it))
    assert ds.features.shape == (10, 16, 16, 1)
    assert ds.labels.shape == (10, 5)


def test_curves_iterator_autoencoder_labels():
    it = fetchers.CurvesDataSetIterator(batch=16, num_examples=32)
    ds = next(iter(it))
    np.testing.assert_array_equal(ds.features, ds.labels)
    assert ds.features.shape == (16, 784)
    _same_batches([ds], [next(iter(jfetchers.CurvesDataSetIterator(
        batch=16, num_examples=32)))])


def test_cifar_flatten_layout_consistent(tmp_path, monkeypatch):
    """``flatten=True`` yields HWC pixel order from real CIFAR binaries and
    from the synthetic source alike."""
    rec = np.zeros(3073, np.uint8)
    rec[0] = 3
    rec[1], rec[1 + 1024], rec[1 + 2048] = 10, 20, 30  # pixel (0, 0) RGB
    (tmp_path / "data_batch_1.bin").write_bytes(np.tile(rec, 4).tobytes())
    monkeypatch.setattr(fetchers, "_search_dirs",
                        lambda env, name: [str(tmp_path)])
    flat = next(iter(fetchers.CifarDataSetIterator(batch=4, shuffle=False,
                                                   flatten=True)))
    img = next(iter(fetchers.CifarDataSetIterator(batch=4, shuffle=False)))
    np.testing.assert_array_equal(flat.features,
                                  img.features.reshape(4, -1))
    np.testing.assert_allclose(flat.features[0, :3],
                               np.array([10, 20, 30]) / 255.0, atol=1e-6)
    monkeypatch.setattr(fetchers, "_search_dirs", lambda env, name: [])
    flat_s = next(iter(fetchers.CifarDataSetIterator(
        batch=4, shuffle=False, flatten=True, num_examples=4)))
    img_s = next(iter(fetchers.CifarDataSetIterator(
        batch=4, shuffle=False, num_examples=4)))
    np.testing.assert_array_equal(flat_s.features,
                                  img_s.features.reshape(4, -1))


def test_csv_strict_single_pass_validation(tmp_path):
    """The numeric fast path validates while parsing in one native pass: a
    single non-numeric or empty field sends the file to the general reader,
    which keeps it (not 0)."""
    ok = tmp_path / "ok.csv"
    ok.write_text("1.5,2,3\n4,5e-1,6\n")
    assert list(CSVRecordReader(ok).records()) == [[1.5, 2.0, 3.0],
                                                   [4.0, 0.5, 6.0]]
    bad = tmp_path / "bad.csv"
    bad.write_text("1,2,3\n4,NA,6\n")
    rows = list(CSVRecordReader(bad).records())
    assert rows == [[1.0, 2.0, 3.0], [4.0, "NA", 6.0]]
    empty_field = tmp_path / "empty.csv"
    empty_field.write_text("1,2\n3,\n")
    rows = list(CSVRecordReader(empty_field).records())
    assert rows[1][1] == ""
    for p in (ok, bad, empty_field):
        assert list(CSVRecordReader(p)) == list(jdv.CSVRecordReader(p))


@pytest.mark.parametrize("skip", [0, 2])
def test_line_reader_and_skip_lines(tmp_path, skip):
    p = tmp_path / "l.csv"
    p.write_text("h1\nh2\n1;2\n3;4\n")
    assert list(LineRecordReader(p)) == list(jdv.LineRecordReader(p))
    rr = CSVRecordReader(p, skip_lines=skip, delimiter=";")
    assert list(rr) == list(jdv.CSVRecordReader(p, skip_lines=skip,
                                                delimiter=";"))
