from .scripts.cli import main

main()
