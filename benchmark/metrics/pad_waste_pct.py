"""pad_waste_pct: padding lanes over all lanes of the multi-tenant
server's buckets (a count the program keeps)."""


def read(run):
    c = run.counters
    if "lanes" not in c:
        return None
    return 100.0 * (c["lanes"] - c["streams"]) / c["lanes"]
