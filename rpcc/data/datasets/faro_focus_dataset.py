"""Faro Focus MEMS dataset (reference ``dataset/datasets/faro_focus_dataset.py``)."""

from rpcc.data.dataset import DatasetTemplate


class FaroFocusDataset(DatasetTemplate):
    pass
