"""Device ms a filter in the operations launched inside the program's
``modppl.lane_words`` spans: the lane keys' SplitMix64 words and their
conversion to uniforms, whoever implements them."""

from portbench.spans import span_ms


def read(rec):
    return span_ms(rec, ["modppl.lane_words"])
