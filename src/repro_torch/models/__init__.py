"""The serving model: configs' families ``dense`` and ``ssm``
(``transformer``), their layers (``layers``, ``ssm``)."""
