"""Host milliseconds a volume spends in the runner's dispatch
(`predict_trits_summary_device`: every tile batch queued, nothing waited
for), the mean over the traced run's window."""


def read(rec):
    spans = rec.spans.get("dispatch")
    return 1e3 * sum(spans) / len(spans) if spans else None
