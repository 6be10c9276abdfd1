"""Distribution substrate of the port (counterpart of
``repro.distributed``): so far the numerics of gradient compression."""
