"""The benchmark's own counts of operations and bytes, from shapes alone,
and the cards' published peaks."""
