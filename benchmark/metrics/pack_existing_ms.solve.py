"""pack_existing_ms.solve: milliseconds a solve's pack spends filling the
existing nodes (``Packer._fill_existing``), the ``pack`` span's
``existing_ms`` attribute, per solve (layer: pack)."""

from benchmark.counters import mean_attr


def read(ctx):
    return mean_attr(ctx, "pack", "existing_ms")
