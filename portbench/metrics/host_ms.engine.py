"""host_ms.engine: the mean host ms of a served frame in the render engine
less its host copy: the program's ``frame`` span less its ``frame.copy``
(the rays, the sampling, the chunks' launches), read from the program's
own spans in the traced window (core/program_spans.py). Moves
``frame_ms``."""

from portbench.core.program_spans import engine_host_ms


def read(r):
    return engine_host_ms(r)
