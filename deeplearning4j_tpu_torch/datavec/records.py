"""Record readers: file -> record (a list of values) streams.

Counterpart of ``deeplearning4j_tpu/datavec/records.py`` (the reference's
DataVec readers). A record is a plain Python list; a CSV file whose every
field is a number is parsed in one pass by the port's host runtime
(``nativert.read_csv_numeric``, strict), and any other CSV goes through
the general reader, which keeps fields that are not numbers as strings.
"""
from __future__ import annotations

import csv
from pathlib import Path
from typing import Iterable, Iterator, List, Optional, Sequence, Union

import numpy as np


class RecordReader:
    """One record per example: a list of values (str or float)."""

    def records(self) -> Iterator[List]:
        raise NotImplementedError

    def __iter__(self) -> Iterator[List]:
        return self.records()

    def reset(self) -> None:
        pass


class CollectionRecordReader(RecordReader):
    """In-memory records (reference DataVec CollectionRecordReader)."""

    def __init__(self, collection: Iterable[Sequence]):
        self._records = [list(r) for r in collection]

    def records(self) -> Iterator[List]:
        return iter([list(r) for r in self._records])


class LineRecordReader(RecordReader):
    """One line per record, single string value."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)

    def records(self) -> Iterator[List]:
        with open(self.path) as f:
            for line in f:
                yield [line.rstrip("\n")]


class CSVRecordReader(RecordReader):
    """Delimited text records (reference DataVec CSVRecordReader). Fields
    parse to float when possible, else stay strings. Fully numeric files use
    the native C++ CSV reader."""

    def __init__(self, path: Union[str, Path], skip_lines: int = 0,
                 delimiter: str = ","):
        self.path = Path(path)
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def _numeric_fast_path(self) -> Optional[np.ndarray]:
        # one native pass validates while parsing (strict): an empty or
        # non-numeric field or a ragged row anywhere gives None (a single
        # 'NA' deep in the file is not read as 0), and the file goes through
        # the general reader below
        from .. import nativert
        return nativert.read_csv_numeric(str(self.path), self.delimiter,
                                         self.skip_lines, strict=True)

    def records(self) -> Iterator[List]:
        fast = self._numeric_fast_path()
        if fast is not None:
            for row in fast:
                yield [float(v) for v in row]
            return
        with open(self.path, newline="") as f:
            rd = csv.reader(f, delimiter=self.delimiter)
            for i, row in enumerate(rd):
                if i < self.skip_lines or not row:
                    continue
                yield [_maybe_float(v) for v in row]


class CSVSequenceRecordReader(RecordReader):
    """One file per sequence, rows are timesteps (reference DataVec
    CSVSequenceRecordReader). ``records`` yields one sequence (list of rows)
    per file, in sorted path order."""

    def __init__(self, paths: Union[str, Path, Sequence[Union[str, Path]]],
                 skip_lines: int = 0, delimiter: str = ","):
        if isinstance(paths, (str, Path)) and Path(paths).is_dir():
            self.paths = sorted(Path(paths).glob("*.csv")) or sorted(
                p for p in Path(paths).iterdir() if p.is_file())
        elif isinstance(paths, (str, Path)):
            self.paths = [Path(paths)]
        else:
            self.paths = [Path(p) for p in paths]
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def sequences(self) -> Iterator[List[List]]:
        for p in self.paths:
            rows = []
            with open(p, newline="") as f:
                rd = csv.reader(f, delimiter=self.delimiter)
                for i, row in enumerate(rd):
                    if i < self.skip_lines or not row:
                        continue
                    rows.append([_maybe_float(v) for v in row])
            yield rows

    def records(self) -> Iterator[List]:
        return self.sequences()


class ImageRecordReader(RecordReader):
    """Image files -> flattened pixel records and the label index of the
    parent directory's name (the reference's ImageRecordReader, as used for
    LFW). PIL is imported when an image is read."""

    def __init__(self, root: Union[str, Path], height: int, width: int,
                 channels: int = 3,
                 extensions: Sequence[str] = (".png", ".jpg", ".jpeg",
                                              ".bmp", ".gif")):
        self.root = Path(root)
        self.height, self.width, self.channels = height, width, channels
        self.files = sorted(p for p in self.root.rglob("*")
                            if p.suffix.lower() in extensions)
        self.labels = sorted({p.parent.name for p in self.files})
        self._label_index = {l: i for i, l in enumerate(self.labels)}

    def num_labels(self) -> int:
        return len(self.labels)

    def _load(self, path: Path) -> np.ndarray:
        from PIL import Image
        img = Image.open(path)
        img = img.convert("RGB" if self.channels == 3 else "L")
        img = img.resize((self.width, self.height))
        arr = np.asarray(img, np.float32) / 255.0
        if self.channels == 1 and arr.ndim == 2:
            arr = arr[..., None]
        return arr

    def records(self) -> Iterator[List]:
        for p in self.files:
            arr = self._load(p).ravel()
            yield [*arr.tolist(), float(self._label_index[p.parent.name])]


def _maybe_float(v: str):
    try:
        return float(v)
    except ValueError:
        return v
