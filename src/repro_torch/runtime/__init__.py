"""Weight-execution handles and serving policy (counterpart of
``repro.runtime``)."""
