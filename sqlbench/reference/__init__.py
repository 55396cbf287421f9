"""The plain references of the query templates, one file each:
``answer(tables, params, acc)`` returns every row the statement
selects, in its ORDER BY order; ``LIMIT`` and ``ORDER_KEY`` (the output
columns the ORDER BY sorts on) say how many of them it returns and which
ties it may break either way. They import no engine code."""
