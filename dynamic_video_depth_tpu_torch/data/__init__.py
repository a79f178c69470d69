"""Datasets and batch conversion (numpy on the host, tensors on the
device), and the dataset registry of ``--dataset``."""

import importlib

DATASETS = ("davis_sequence", "shutterstock")


def get_dataset(alias: str):
    """``--dataset`` name -> its ``Dataset`` class (reference
    datasets/__init__.py:18-20)."""
    if alias not in DATASETS:
        raise ValueError(f"dataset {alias!r} not in {DATASETS}")
    module = importlib.import_module(f"{__name__}.{alias}")
    return module.Dataset
