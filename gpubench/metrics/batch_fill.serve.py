"""batch_fill.serve (%): images asked for over the rows the engine ran
(asked plus padding) in the window's batches, from the engine's counters."""


def read(record, trace):
    used = record["engine"]["images"]
    rows = used + record["engine"]["padded_images"]
    return 100.0 * used / rows if rows > 0 else None
