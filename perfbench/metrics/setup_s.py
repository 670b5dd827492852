"""Process start to the first round of the window, on the host clock:
imports, the kernels' build or load, the inputs made on the device and
the warm-up rounds."""


def read(rec):
    return rec["setup_s"]
