"""The reference's scalar oracles and legacy random streams, copied from
``flexpart_tpu/validation`` (numpy only, imports pointed at the port's
``constants`` and ``met.fields``): the matched-RNG validation path of the
port (``core/legacy.py``) is held against them."""
