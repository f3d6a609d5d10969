"""request_p95_s.serve (s): the 95th percentile of send-to-parsed-answer
of every request sent in the window (those open at its close waited for;
a failed request is missing and leaves nothing to read). In a traced run,
over the requests answered before the trace was asked for."""


def read(record, trace):
    return record.get("request_p95_s")
