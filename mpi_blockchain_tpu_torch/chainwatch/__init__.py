"""The port's part of the reference's ``chainwatch``: the open-incident
table (``incident.py``) that the front door's degradation stamp reads.
The anomaly rules, the evidence bundles, ``emit_incident`` and
``--incident-dir`` are not ported yet."""
