"""The plain reference that decides ``correct``: frozen copies, taken at
commit cb1d0d9, of the port's firmware twin and what it stands on
(``golden/model.py`` and ``golden/qref.py`` as ``model.py`` and
``qref.py``; ``params/design.py``, ``params/types.py``, ``core/fmath.py``,
``core/qmath.py`` and ``core/constants.py`` under their own names), with
their imports made local.  They import nothing of the port, so a change to
the port cannot move the yardstick.  ``config.py`` builds a device
configuration from a configuration file; ``lanes.py`` runs the golden
model over sampled streams in the program's state layout."""
