"""Samplers: the stretch move and parallel tempering (plain torch move
law, ``stretch``/``tempered``), the kernel-driven runners (``kernel``),
the MLE warm start (``mle``) and the fit driver (``driver``)."""
