"""Physics modules of the port (``flexpart_tpu/physics``): so far the
Emanuel convection scheme and the particle redistribution."""
