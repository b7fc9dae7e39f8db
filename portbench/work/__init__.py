"""Work per configuration, counted from shapes and frozen: ``<config>.py``
defines ``step_flops(b, d)`` (one fit step of one replica) and
``rowprod(b, d)``, ``smallspace(b, d)`` and ``apply(b, d)`` as (FLOPs,
bytes) of one step's row products and score, one small-space update, and
one fat apply.  Every byte of an input is counted read once and of an output
written once (float32, 4 bytes), the least the work needs whatever a kernel
reads again; where an algorithm has a choice, the least work is counted."""
