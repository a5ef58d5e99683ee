"""Which public exports of ``polara_tpu`` have no port yet.

``UNPORTED`` lists, per ``polara_tpu`` package, the exported names (its
``__all__``; for a package without one, the functions it defines) that the
same-named ``polara_tpu_torch`` package does not provide yet.  A listed
name that gains a port, or an unlisted one that lacks it, fails a test:
the list shrinks with every slice of the port (ROADMAP queue A)."""
import importlib
import pkgutil

import polara_tpu

# unported public names, per polara_tpu package (none left: every
# export has its port)
UNPORTED = {}


def _exports(module):
    names = getattr(module, "__all__", None)
    if names is not None:
        return set(names)
    return {name for name, value in vars(module).items()
            if not name.startswith("_") and callable(value)
            and getattr(value, "__module__", None) == module.__name__}


def _port_gaps():
    """``{polara_tpu package: names its port lacks}`` over the top level
    and every subpackage, nested ones included."""
    packages = ["polara_tpu"] + [
        info.name
        for info in pkgutil.walk_packages(polara_tpu.__path__,
                                          prefix="polara_tpu.")
        if info.ispkg]
    gaps = {}
    for name in packages:
        try:
            port = importlib.import_module(
                name.replace("polara_tpu", "polara_tpu_torch", 1))
        except ModuleNotFoundError:
            port = None
        missing = {export for export in
                   _exports(importlib.import_module(name))
                   if port is None or not hasattr(port, export)}
        if missing:
            gaps[name] = missing
    return gaps


def test_listed_names_have_no_port_yet():
    gaps = _port_gaps()
    ported = {f"{package}:{name}" for package, names in UNPORTED.items()
              for name in names - gaps.get(package, set())}
    assert not ported, (f"now ported, remove from UNPORTED: "
                        f"{sorted(ported)}")


def test_every_unported_name_is_listed():
    gaps = _port_gaps()
    unlisted = {f"{package}:{name}" for package, names in gaps.items()
                for name in names - UNPORTED.get(package, set())}
    assert not unlisted, (f"no port and not in UNPORTED: "
                          f"{sorted(unlisted)}")
