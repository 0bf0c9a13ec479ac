"""setup_s: from the process's start to the first timed query: imports, the
CUDA context, the kernel library (built by nvcc on a checkout's first
run), the tables made on the card, and the warm-up rounds."""


def read(w):
    return w.setup_s
