"""Notebook display helpers (reference ``polara/tools/display.py:6-30``;
host copy of :mod:`polara_tpu.runtime.display`)."""
from __future__ import annotations

import contextlib
import os
import sys


def print_frames(dataframes, names=None):
    """Render several DataFrames side by side (HTML in notebooks, plain
    concatenation otherwise)."""
    try:
        from IPython.display import HTML, display
    except ImportError:
        for frame in dataframes:
            print(frame)
        return None

    border_style = "\'border: none\'"
    cells = [f"<td style={border_style}> {frame.to_html(index=True)} </td>"
             for frame in dataframes]
    table = f"<table style={border_style}><tr>{''.join(cells)}</tr></table>"
    return display(HTML(table))


@contextlib.contextmanager
def suppress_stdout():
    """Silence stdout within the context (reference ``display.py:21-30``)."""
    with open(os.devnull, "w") as devnull:
        old_stdout = sys.stdout
        sys.stdout = devnull
        try:
            yield
        finally:
            sys.stdout = old_stdout
