"""The learned collision field's (body, part, scene point) rows per request
in the traced stretch: the program's counter `Predictor.field_rows`
(counted where the guidance runs, replays included), over the requests.
None where the program has no such counter or the field ran no row (the
mesh SDF). It is work the configuration asks for: fewer rows means less
of the scene was read, so it is declared `better: higher`."""
MOVES = "bodies_per_s"
UNIT = "rows"


def read(r):
    t = r.trace
    if t is None or not t.units or not t.counters.get("field_rows"):
        return None
    return t.counters["field_rows"] / t.units
