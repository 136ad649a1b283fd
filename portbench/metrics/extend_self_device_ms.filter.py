"""Device ms a filter in the operations launched inside the program's
``modppl.extend`` spans (the init generate and each step's extend) less
those inside its ``modppl.lane_words`` spans: the model's own work over
the particles."""

from portbench.spans import span_ms


def read(rec):
    return span_ms(rec, ["modppl.extend"], less=["modppl.lane_words"])
