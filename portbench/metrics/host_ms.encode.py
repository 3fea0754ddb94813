"""host_ms.encode: the mean host ms of the service's ``request.encode``
span, the npy encode and the response's write, read from the program's
own spans in the traced window (core/program_spans.py). Moves
``frame_ms``."""

from portbench.core.program_spans import encode_host_ms


def read(r):
    return encode_host_ms(r)
