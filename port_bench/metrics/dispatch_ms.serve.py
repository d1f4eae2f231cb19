"""dispatch_ms.serve: mean host ms from the call into `Predictor.predict`
to its return, before the synchronize, over the window's (unprofiled)
requests."""


def read(ctx: dict):
    if ctx.get("kind") != "serve" or not ctx.get("dispatch_s"):
        return None
    return sum(ctx["dispatch_s"]) / len(ctx["dispatch_s"]) * 1e3
