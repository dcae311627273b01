"""Mean Hessian matvecs per registration of the window
(``RegistrationResult.matvecs``, an exact count)."""


def read(run):
    if not run.solves:
        return None
    return sum(s["matvecs"] for s in run.solves) / len(run.solves)
