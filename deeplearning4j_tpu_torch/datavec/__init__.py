"""DataVec's ETL entry: record readers and the iterators that turn their
records into ``DataSet`` batches (counterpart of
``deeplearning4j_tpu/datavec/``). Everything here is host data: numpy
arrays on the CPU, which ``fit`` and ``fit_iterator`` move to the card."""
from .iterators import (
    RecordReaderDataSetIterator, RecordReaderMultiDataSetIterator,
    SequenceRecordReaderDataSetIterator)
from .records import (
    CollectionRecordReader, CSVRecordReader, CSVSequenceRecordReader,
    ImageRecordReader, LineRecordReader, RecordReader)

__all__ = [
    "CSVRecordReader", "CSVSequenceRecordReader", "CollectionRecordReader",
    "ImageRecordReader", "LineRecordReader", "RecordReader",
    "RecordReaderDataSetIterator", "RecordReaderMultiDataSetIterator",
    "SequenceRecordReaderDataSetIterator",
]
