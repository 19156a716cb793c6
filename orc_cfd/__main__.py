from orc_cfd.cli import main

raise SystemExit(main())
