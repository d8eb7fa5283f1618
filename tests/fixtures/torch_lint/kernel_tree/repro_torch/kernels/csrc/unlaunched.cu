// fixture: RL004, no build.launch names this library
