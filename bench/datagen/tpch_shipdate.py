"""TPC-H ``LINEITEM.L_SHIPDATE`` as dbgen lays it out (TPC-H v3.0.1 §4.2.3).

Orders carry a uniform ``O_ORDERDATE`` in [STARTDATE, ENDDATE - 151 days];
each has 1 to 7 line items, stored in order-key order; ``L_SHIPDATE`` is its
order's date plus 1 to 121 days.  Dates are ``date32`` (int32 days since
1970-01-01); the column has no nulls.  The row count is fixed by the
configuration (6,001,215 at scale factor 1), so every seed does the same
work.
"""

from __future__ import annotations

import numpy as np

from ..reference import Column

START_DATE = 8035  # 1992-01-01
END_DATE = 10591  # 1998-12-31
LAST_ORDER_DATE = END_DATE - 151
LINES_PER_ORDER = (1, 7)
SHIP_DELAY_DAYS = (1, 121)


def make(spec: dict, rows: int, rng: np.random.Generator) -> Column:
    lo, hi = LINES_PER_ORDER
    # enough orders for any draw of line counts (mean 4 to an order)
    lines = rng.integers(lo, hi + 1, rows // lo + 1)
    n_orders = int(np.searchsorted(np.cumsum(lines), rows)) + 1
    order_of_row = np.repeat(np.arange(n_orders), lines[:n_orders])[:rows]
    order_date = rng.integers(START_DATE, LAST_ORDER_DATE + 1, n_orders)
    d_lo, d_hi = SHIP_DELAY_DAYS
    ship = order_date[order_of_row] + rng.integers(d_lo, d_hi + 1, rows)
    return Column(validity=np.ones(rows, bool), values=ship.astype(np.int32))
