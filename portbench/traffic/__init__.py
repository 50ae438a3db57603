"""Traffic: one data file of parameters per mix (``<traffic>.json``), read by
the general generators here."""
