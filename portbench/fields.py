"""The categorical fields' rows in the one table both sides embed from.

A configuration's ``field_cardinalities`` gives each categorical field's
distinct values n. The field's local ids are 1 .. n and id 0 is the
port's padding and out-of-vocabulary row, so the field takes n + 1 rows;
the fields' rows follow one another in field order, and the table is
padded to a multiple of ``ROW_PAD`` rows.
"""

from __future__ import annotations

import itertools

ROW_PAD = 128


def vocab_sizes(config: dict) -> list[int]:
    """Each categorical field's rows, row 0 included."""
    sizes = [int(n) + 1 for n in config["field_cardinalities"]]
    if len(sizes) != config["sparse_fields"]:
        raise ValueError(f"{len(sizes)} field cardinalities for "
                         f"{config['sparse_fields']} categorical fields")
    return sizes


def offsets(config: dict) -> list[int]:
    """Each categorical field's first row in the table."""
    return [0, *itertools.accumulate(vocab_sizes(config))][:-1]


def table_rows(config: dict) -> int:
    rows = sum(vocab_sizes(config))
    return -(-rows // ROW_PAD) * ROW_PAD
