"""Dataframe display helper (copy of ``mmdx_tpu/utils/dataframe.py``; the
reference's print_clean_df,
backend/ml/pipelines/helper.py:5-24 — duplicated inline in both pipelines
there; a single shared utility here)."""
from __future__ import annotations


def print_clean_df(df, num_rows: int = 10, max_col_width: int = 40,
                   printer=print) -> None:
    """Print the head of a dataframe with long cells truncated."""
    view = df.head(num_rows).copy()
    for col in view.columns:
        view[col] = view[col].map(
            lambda v: (s[: max_col_width - 3] + "...")
            if len(s := str(v)) > max_col_width else s
        )
    printer(view.to_string(index=False))
