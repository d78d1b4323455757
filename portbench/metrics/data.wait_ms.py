"""Host milliseconds a step waits for its batch on the iterable the epoch
pass was handed (the Prefetcher, or the resident pool), the mean over the
traced run's window."""


def read(rec):
    spans = rec.spans.get("data_wait")
    return 1e3 * sum(spans) / len(spans) if spans else None
