"""Iteration logging (counterpart of mpc_tpu/utils/logging.py, the
reference's ``util.table_log``, mpc/util.py:77-99)."""

from __future__ import annotations

_seen_tables = set()


def table_log(tag, d):
    """Print one markdown-ish table row, with a header the first time a
    tag is seen in the process.  ``d`` is a sequence of (name, value[,
    fmt]) tuples."""

    def print_row(r):
        print('| ' + ' | '.join(r) + ' |')

    if tag not in _seen_tables:
        print_row([str(di[0]) for di in d])
        _seen_tables.add(tag)

    s = []
    for di in d:
        if len(di) not in (2, 3):
            raise ValueError('table_log takes (name, value[, fmt]) tuples')
        s.append(di[2].format(di[1]) if len(di) == 3 else str(di[1]))
    print_row(s)
