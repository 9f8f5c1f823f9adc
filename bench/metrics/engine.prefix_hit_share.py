"""Share of the window's prompt tokens served from the prefix cache:
``sum(prefix_hit_pages) * page / sum(prompt tokens)``, in percent."""

LAYER = "engine (launch/engine.py)"
MOVES = "ttft_p90_ms"
UNIT = "%"


def read(run):
    recs = run.obs.get("records")
    if not recs:
        return None
    page = run.cfg["serving"]["kv_cache"]["block"]
    hit = sum(x["hit_pages"] for x in recs) * page
    return 100.0 * hit / sum(len(x["prompt"]) for x in recs)
