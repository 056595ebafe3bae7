"""setup_s: seconds from the harness's first statement to the start of the
first timed interval: torch's import, the kernels' build on a cold checkout,
the CUDA context, the inputs made on the card, the path's set-up and the
warm intervals (host clock)."""


def read(s: dict):
    return s["setup_s"]
