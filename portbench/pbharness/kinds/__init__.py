"""One module per kind of traffic (a traffic file's ``kind``): ``edit``
(closed-loop batched text edits) and ``pcx`` (PC extraction)."""
