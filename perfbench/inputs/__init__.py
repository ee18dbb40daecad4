"""Input makers: each configuration's `data` key names one module here."""

import importlib


def data_module(name: str):
    return importlib.import_module(f"perfbench.inputs.{name}")
