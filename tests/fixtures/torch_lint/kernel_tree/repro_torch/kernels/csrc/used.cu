// fixture: launched by orphan.py
