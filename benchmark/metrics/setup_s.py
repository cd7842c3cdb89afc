"""``setup_s``: process start to the first timed call (host clock): imports,
the card's start, kernel builds where the checkout has none yet, weights,
rendering the frames and warming the cell's shapes."""


def read(record):
    return record.setup_s
