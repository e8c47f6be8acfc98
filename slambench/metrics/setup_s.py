"""Set-up seconds: from the start of the process to the end of warm-up
(imports, the card, the kernels, the frames, the vocabulary, warm-up)."""

def read(rec):
    return rec.setup_s
