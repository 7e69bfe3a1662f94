"""march_tables_idle_ms.relight: the device's idle ms a relight step while
the host builds the dense marches' tap and step tables and copies them to
the card (vct.dense.plan, inside the three marches' stages), over the
profiled steps (vctbench/spans.py)."""

from vctbench import spans


def read(ctx):
    return spans.mean(spans.idle_ms(ctx, ("dense.plan",)))
